#!/usr/bin/env python3
"""How phases 23 and 27 of ``chip_smoke.py`` pick each config's learning
rate, xLSTM's sequence and StarCoder2-15B's depth: short training runs at
the phases' cuts and batches, one JSON line per run (every step's loss,
MoE aux, grad norm and host seconds, and the peak card memory). One GPU:

    python3 tools/torch_family_probe.py ARCH[:SEQ][@LAYERS][,...] LRS STEPS

LRS is one learning rate or several, comma-separated.

ARCH is a key of ``chip_smoke.family_cases()`` (``olmoe_1b_7b``,
``grok_1_314b``, ``jamba_1_5_large_398b``, ``xlstm_125m``) or of
``chip_smoke.untrained_cases()`` (``star_paper_star``, ``chatglm3_6b``,
``chatglm3_6b_star``, ``starcoder2_15b``), trained at the case's batch,
its layers (LAYERS where given) and SEQ tokens a row where given (else
the case's), from ``lm.init`` with seed 0, through
``chip_smoke.train_run`` (``SyntheticLM``, warmup 5, a cosine schedule
over STEPS). For example ``python3 tools/torch_family_probe.py
xlstm_125m:2048 3e-3 2`` times two steps of xLSTM-125M at the published
2048 tokens, and ``starcoder2_15b@18 6e-4 3`` reads the peak memory of
18 of StarCoder2-15B's layers.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("torch_family_probe: no CUDA device", file=sys.stderr)
        return 1
    archs, lrs, steps = argv[0].split(","), argv[1].split(","), int(argv[2])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    cases = {**cs.family_cases(), **cs.untrained_cases()}
    card = torch.cuda.get_device_name(0)
    for arch in archs:
        arch, _, layers = arch.partition("@")
        name, _, seq = arch.partition(":")
        case = cases[name]
        layers = int(layers or case.layers)
        cfg = cs.cut_layers(case.cfg, layers)
        for lr in map(float, lrs):
            params, _ = cs.init_params(cfg, gen, dev)
            _, opt_init, _ = cs.launch_steps.make_optimizer(cfg, lr)
            opt = opt_init(params)
            torch.cuda.reset_peak_memory_stats()
            run = cs.train_run(cfg, params, opt, steps=steps,
                               seq=int(seq or case.seq), batch=case.batch,
                               ckpt_dir=None, dev=dev, lr=lr)
            print(json.dumps({
                "card": card, "arch": name, "layers": layers,
                "batch": case.batch, "seq": int(seq or case.seq), "lr": lr,
                "loss": run["loss"], "aux": run["aux"],
                "grad_norm": run["grad_norm"], "step_s": run["step_s"],
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
                flush=True)
            del params, opt, run
            cs.free_cache(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
