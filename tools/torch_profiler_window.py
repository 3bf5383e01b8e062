#!/usr/bin/env python3
"""How much of a short ``torch.profiler`` window's device work the trace
keeps, over one process's life on one GPU. One GPU:

    python3 tools/torch_profiler_window.py [SECONDS] [EVERY]

For SECONDS (default 420) the card multiplies bf16 matrices; every EVERY
seconds (default 30) it profiles two windows of 10 calls of a 4096^3
bf16 matmul (each after an L2 flush, as ``chip_smoke.flash_bwd_split``
times a backward): one with the calls at once, one with the calls after
``LEAD_S`` of host sleep inside the window. For each window one JSON line:
the process's age, the launches the trace holds on the host side
(runtime launch events) and kernels on the device side, and the device
start of each kernel less the host start of its launch (matched by
correlation id; the least and the median, ms). A kernel's device time
cannot precede its launch, so a negative least lead is the trace's device
clock reading behind its host clock, and a least lead far above a
launch's latency the device clock reading ahead. In a busy process the
trace can lack a session's first launches or all of them;
``chip_smoke.flash_bwd_split`` pads its windows with host sleep and runs
a session again until its trace holds every launch.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

LEAD_S = 0.1
L2_FLUSH_BYTES = 256 << 20


def window(fn, flush, lead_s: float, iters: int = 10) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_s)
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    leads = sorted((e.start_ns() - launches[e.correlation_id()]) / 1e6
                   for e in kernels if e.correlation_id() in launches)
    return {"lead_s": lead_s, "host_launches": len(launches),
            "device_kernels": len(kernels),
            "matched": len(leads),
            "min_lead_ms": leads[0] if leads else None,
            "median_lead_ms": leads[len(leads) // 2] if leads else None}


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_window: no CUDA device", file=sys.stderr)
        return 1
    seconds = float(argv[0]) if argv else 420.0
    every = float(argv[1]) if len(argv) > 1 else 30.0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((4096, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def fn():
        return a @ a
    while True:
        age = time.perf_counter() - t0
        for lead_s in (0.0, LEAD_S):
            print(json.dumps({"age_s": age, **window(fn, flush, lead_s)}),
                  flush=True)
        if age >= seconds:
            return 0
        until = time.perf_counter() + every
        while time.perf_counter() < until:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
