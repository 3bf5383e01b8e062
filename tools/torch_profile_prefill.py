#!/usr/bin/env python3
"""Where one whole-prompt prefill of the PyTorch port spends its time on
a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_profile_prefill.py [--arch chatglm3_6b] [--tokens 4096]
    python3 tools/torch_profile_prefill.py --arch olmoe_1b_7b --tokens 4096
    python3 tools/torch_profile_prefill.py --arch jamba_1_5_large_398b \
        --tokens 4096
    python3 tools/torch_profile_prefill.py --arch xlstm_125m --tokens 2048

It builds the kernels, draws the config's full-size weights (default
olmo_1b) from seed 0, at the launcher's ``--full`` depth (Jamba-1.5-Large
its first 5 layers, Grok-1 2; ``launch.serve.model_config``), and runs
one ``--tokens``-token (default 2048) ``lm.prefill`` with STAR on (K2 ->
SADS -> K3) and off (K4), alternating the two six times (the first pair
is the warm-up; a config without STAR, such as xLSTM, runs the one form
six times). For each it prints
one JSON line: the host time through the device's end (median of the
last five, and all five), then one more run under ``torch.profiler``
with its wall, the kernels' summed device time, the busy time (the union
of the kernels' intervals), the busy share of the unprofiled median wall
(the profiler slows the host, not the kernels) and of the profiled wall,
the kernels that take the most device time (ranges' device-side spans
left out), and the device time of the kernels inside the GQA expansion
(``attention._repeat_kv``, which copies K and V to n_heads width before
K2, K3 and K4) with its share of the device time.
The expansion is also timed alone with CUDA events (K and V of every
attention layer, at the prefill's shape).

The profiled run also splits the device time by block
(``repro_torch.profiling.model_ranges`` / ``prefill_split``): the
attention blocks (``attention.apply_prefill``), of which K2 and K3
(kernels named ``dlzs``/``sufa``), K4 (``flash``) and the GQA expansion;
the MoE (``moe.apply``), of which the expert FFN (``moe.expert_ffn``: the
batched matmuls over every expert and the activation) and the glue (gate,
dispatch, combine); the Mamba blocks (``ssm.apply``), of which the SSD
chunk scan (``ssm.chunked_linear_attention``); the mLSTM and sLSTM blocks,
of which the sLSTM time loop (``xlstm._slstm_scan``); everything else
(norms, residual adds, embedding, output head); and the GEMM kernels by
name, wherever they ran.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.serve import model_config  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.profiling import (device_kernels,  # noqa: E402
                                   model_ranges, prefill_split,
                                   range_device_ms, ranged)

SEED = 0
REPEATS = 6
REPEAT_KV = "attention._repeat_kv"   # the range around each GQA expansion


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def time_repeat_kv(cfg, t: int, dev) -> dict:
    """``attention._repeat_kv`` alone on one layer's K (or V) at the
    prefill's shape, median device time of 20 calls (CUDA events), and
    the sum over K and V of every attention layer."""
    n_rep = cfg.n_heads // cfg.n_kv
    x = torch.randn((1, t, cfg.n_kv, cfg.dh), device=dev).to(cfg.dtype)
    times = []
    for i in range(23):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        attention._repeat_kv(x, n_rep)
        b.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))
    one = float(np.median(times))
    layers = cfg.n_repeat * sum(blk.kind == "attn" for blk in cfg.pattern)
    return {"n_rep": n_rep, "attention_layers": layers, "ms_one_call": one,
            "ms_per_prefill": one * 2 * layers,
            "bytes_written_per_prefill": 2 * layers * t * cfg.n_heads
            * cfg.dh * x.element_size()}


@torch.inference_mode()
def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--tokens", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_prefill: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    build.build()
    cfg = model_config(args.arch, full=True)
    t = args.tokens
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = lm.init(cfg, gen, dev)
    rng = np.random.RandomState(SEED + 5)
    batch = {"tokens": torch.as_tensor(
        rng.randint(2, cfg.vocab, size=(1, t)).astype(np.int32), device=dev)}
    last = torch.tensor([t - 1], dtype=torch.int32, device=dev)

    ranges = model_ranges(cfg)
    has_attn = any(blk.kind == "attn" for blk in cfg.pattern)
    modes = {"dense": cfg} if cfg.star is None else \
        {"star": cfg, "dense": dataclasses.replace(cfg, star=None)}

    def run(c):
        lm.prefill(params, c, batch, last_index=last)
        torch.cuda.synchronize()

    walls = {name: [] for name in modes}
    for _ in range(REPEATS):
        for name, c in modes.items():
            t0 = time.perf_counter()
            run(c)
            walls[name].append(time.perf_counter() - t0)
    for name, c in modes.items():
        with ranged(ranges), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(c)
            wall = 1e3 * (time.perf_counter() - t0)
        names = set(ranges.values())
        device_ms, busy_ms, top = device_kernels(prof, names)
        repeat_ms = range_device_ms(prof, REPEAT_KV, names) \
            if has_attn else 0.0
        unprofiled = 1e3 * float(np.median(walls[name][1:]))
        emit("profile_prefill", arch=args.arch, attention=name, T=t,
             wall_ms_unprofiled=unprofiled,
             wall_ms_unprofiled_all=[1e3 * w for w in walls[name][1:]],
             wall_ms_profiled=wall, device_ms=device_ms, busy_ms=busy_ms,
             busy_share=busy_ms / unprofiled,
             busy_share_profiled=busy_ms / wall,
             repeat_kv_device_ms=repeat_ms,
             repeat_kv_share_of_device=repeat_ms / device_ms,
             kernels=top[:20],
             split=prefill_split(prof, ranges, device_ms, top))
    if has_attn:
        emit("repeat_kv_alone", arch=args.arch, T=t,
             **time_repeat_kv(cfg, t, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
