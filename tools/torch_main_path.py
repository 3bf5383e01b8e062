#!/usr/bin/env python3
"""``chip_smoke.py``'s served OLMo-1B phases alone, to compare two
checkouts of the port on one card.

Run from any directory on a machine with one NVIDIA GPU:

    python3 tools/torch_main_path.py [--root DIR] [--runs N]

It imports ``chip_smoke.py`` from ``DIR`` (default: this checkout), so the
port under ``DIR/src`` is the one served and its kernels are built from
``DIR``'s sources. With the smoke's own helpers, weights seed and prompts
it serves full-width OLMo-1B ``N`` times: phase 3 (the main path, chunked
prefill, a fresh engine and its warm-up request each run) and phase 8 (the
whole-prompt prefill, after one untimed prefill of each prompt length). It
prints one JSON line per run and phase with that phase's summary, K1's
launch count held to ticks x layers. To compare a parent and a change,
run it for each checkout in turn, parent, change, change, parent, within
one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    smoke.build.build()
    dev = torch.device("cuda")
    cfg = smoke.olmo_1b.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    params = smoke.lm.init(cfg, gen, dev)
    prompts = smoke.make_prompts(cfg, smoke.MAIN_PROMPTS, smoke.SEED)
    whole_prompts = smoke.make_prompts(cfg, smoke.WHOLE_PROMPTS,
                                       smoke.SEED + 4)
    for p in whole_prompts:
        smoke.lm.prefill(params, cfg, {"tokens": torch.as_tensor(
            p, device=dev)[None]})
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for i in range(args.runs):
        llm = smoke.main_path_llm(cfg, params, n_pages=1024, hot_pages=64,
                                  past_pages=64, device=dev, generator=gen)
        smoke.serve(llm, smoke.make_prompts(cfg, (128,), smoke.SEED + 1), 2)
        llm.clear_finished()
        main = smoke.served_summary(smoke.serve(llm, prompts,
                                                smoke.MAIN_MAX_TOKENS),
                                    cfg.n_layers)
        smoke.require_launches(main, "main path")
        del llm
        torch.cuda.empty_cache()
        llm, _, whole = smoke.serve_whole_prompt(
            cfg, params, whole_prompts, smoke.WHOLE_MAX_TOKENS, device=dev,
            generator=gen)
        smoke.require_launches(whole, "whole-prompt prefill")
        del llm
        torch.cuda.empty_cache()
        for phase, summary in (("main_path", main),
                               ("whole_prompt_prefill", whole)):
            print(json.dumps({"root": str(root), "card": card, "run": i,
                              "phase": phase, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
