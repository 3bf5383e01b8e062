#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: Nemotron-4-340B trained at
head_dim 192 on one GPU. Builds the attention kernels (printing ptxas's
registers and spills for K4's and K3's backwards), then runs
``chip_smoke.check_nemotron_training``: (a) both backwards at the
training shape against their plain versions, timed, with their kernels'
device times from a profiler trace; (b) one layer's
gradient at published width, dense and with ``star_train``; (c) 1 of 96
layers trained with Adafactor and ``train_accum`` 8, dense and with
``star_train``. Each check prints its JSON line; the card's name and power
limit come first.

    python3 tools/torch_nemotron_train.py [LR]

(about 4 minutes on an H100 after the builds). LR, the base learning
rate of (c), defaults to the phase's (``chip_smoke.NEMOTRON_TRAIN_LR``):
the runs that chose it.

    python3 tools/torch_nemotron_train.py --compare LR [STEPS]

trains (c)'s 1-of-96-layer cut at LR for STEPS steps (default the
phase's, ``chip_smoke.NEMOTRON_TRAIN_STEPS``), dense and then with
``star_train``, each twice from the same weights on the same batches:
on the kernel path, and on the plain path with K4 and K3 (and K2)
swapped for their plain versions under autograd
(``chip_smoke.plain_attention``, phase 20d's plain path). Each
run prints its per-step losses and grad norms, its kernel launches (0 on
the plain path) and whether it diverged (its last loss above its first);
each pair, the first step whose losses differ by more than 1%.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


PARTED = 0.01               # losses this far apart (relative) have parted


def train_path(cfg, dev, lr: float, steps: int, plain: bool) -> dict:
    """``steps`` steps of ``cfg`` from ``lm.init`` (seed 0) on
    ``SyntheticLM``'s batches, as phase 25c trains it, on the kernel or
    the plain path."""
    params, _ = cs.init_params(cfg, torch.Generator(device=dev), dev)
    _, opt_init, _ = cs.launch_steps.make_optimizer(cfg, lr)
    opt_state = opt_init(params)
    cs.kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with cs.plain_attention() if plain else contextlib.nullcontext():
        run = cs.train_run(cfg, params, opt_state, steps=steps,
                           seq=cs.TRAIN_SEQ, batch=cs.TRAIN_BATCH,
                           ckpt_dir=None, dev=dev, lr=lr)
    out = {"arch": cfg.name, "star_train": cfg.star_train,
           "path": "plain" if plain else "kernel", "lr": lr,
           "loss": run["loss"], "grad_norm": run["grad_norm"],
           "step_ms_median": 1e3 * sorted(run["step_s"][1:])[
               len(run["step_s"][1:]) // 2],
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": {k: v for k, v in cs.launched().items() if v}}
    last, first = run["loss"][-1], run["loss"][0]
    out["diverged"] = not math.isfinite(last) or last > first
    cs.emit("nemotron_lr_path", **out)
    del run, params, opt_state
    cs.free_cache(dev)
    return out


def compare(dev, lr: float, steps: int) -> dict:
    """Both paths at ``lr``, dense and with ``star_train``: where their
    losses part, and which diverge."""
    cfg = cs.cut_layers(cs.nemotron_4_340b.config(),
                        cs.NEMOTRON_TRAIN_LAYERS)
    out = {}
    for name, c in (("dense", cfg),
                    ("star", dataclasses.replace(cfg, star_train=True))):
        kernel = train_path(c, dev, lr, steps, plain=False)
        plain = train_path(c, dev, lr, steps, plain=True)
        parted = next((i for i, (a, b) in enumerate(zip(kernel["loss"],
                                                         plain["loss"]))
                       if not abs(a - b) <= PARTED * abs(b)), None)
        out[name] = {"kernel_diverged": kernel["diverged"],
                     "plain_diverged": plain["diverged"],
                     "parted_at_step": parted,
                     "loss_kernel": kernel["loss"],
                     "loss_plain": plain["loss"]}
        cs.emit("nemotron_lr_compare", case=name, lr=lr, steps=steps,
                layers=cs.NEMOTRON_TRAIN_LAYERS, **out[name])
    return out


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("torch_nemotron_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    built = build.build(["dlzs_block", "sufa", "flash", "flash_bwd",
                         "sufa_bwd"])
    cs.emit("build", seconds=time.perf_counter() - t0)
    for name in ("flash_bwd", "sufa_bwd"):
        for fn, line in cs.ptxas_report(built[name]["log"]):
            print(f"ptxas[{name}] {fn} {line}", flush=True)
    dev = torch.device("cuda")
    if argv[:1] == ["--compare"]:
        compare(dev, float(argv[1]),
                int(argv[2]) if len(argv) > 2 else cs.NEMOTRON_TRAIN_STEPS)
        return 0
    lr = float(argv[0]) if argv else cs.NEMOTRON_TRAIN_LR
    cs.check_nemotron_training(cs.nemotron_4_340b.config(), dev,
                               torch.Generator(device=dev), lr=lr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
