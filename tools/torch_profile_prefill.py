#!/usr/bin/env python3
"""Where one whole-prompt prefill of the PyTorch port's olmo_1b spends its
time on a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_profile_prefill.py

It builds the kernels, draws olmo_1b's weights from seed 0, and runs one
2048-token ``lm.prefill`` with STAR on (K2 -> SADS -> K3) and off (K4),
alternating the two six times (the first pair is the warm-up). For each
it prints one JSON line: the host time through the device's end
(median of the last five, and all five), then one more run under
``torch.profiler`` with its wall, the kernels' summed device time, the
busy time (the union of the kernels' intervals), the busy share of the
unprofiled median wall (the profiler slows the host, not the kernels)
and of the profiled wall, and the kernels that take the most device
time.
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

from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SEED = 0
T = 2048
REPEATS = 6


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def device_kernels(prof) -> tuple[float, float, list]:
    """From a profile: the summed device time of its kernels (ms), the
    time the device was busy (the union of their intervals, ms) and the
    kernels by name, most device time first."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return total / 1e3, busy / 1e3, [
        {"name": name[:90], "calls": calls, "device_ms": us / 1e3}
        for name, (calls, us) in top]


@torch.inference_mode()
def main() -> int:
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
    cfg = olmo_1b.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = lm.init(cfg, gen, dev)
    rng = np.random.RandomState(SEED + 5)
    batch = {"tokens": torch.as_tensor(
        rng.randint(2, cfg.vocab, size=(1, T)).astype(np.int32), device=dev)}
    last = torch.tensor([T - 1], dtype=torch.int32, device=dev)
    modes = {"star": cfg, "dense": dataclasses.replace(cfg, star=None)}

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(c)
            wall = 1e3 * (time.perf_counter() - t0)
        device_ms, busy_ms, top = device_kernels(prof)
        unprofiled = 1e3 * float(np.median(walls[name][1:]))
        emit("profile_prefill", attention=name, T=T,
             wall_ms_unprofiled=unprofiled,
             wall_ms_unprofiled_all=[1e3 * w for w in walls[name][1:]],
             wall_ms_profiled=wall, device_ms=device_ms, busy_ms=busy_ms,
             busy_share=busy_ms / unprofiled,
             busy_share_profiled=busy_ms / wall, kernels=top[:14])
    return 0


if __name__ == "__main__":
    sys.exit(main())
