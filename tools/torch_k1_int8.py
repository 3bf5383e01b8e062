#!/usr/bin/env python3
"""K1's two forms side by side on a GPU: what the int8 form (the cold KV
tier) costs over the fp form, by how many slots read int8 rows.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_k1_int8.py

At ``chip_smoke.py``'s main-path shape (B 4, G 16, d 128, page 16, W 64,
P 1024, kv_len 1024/1000/777/500) it times, with ``chip_smoke.time_ms``
(median of 50 launches, each after an L2 flush and a device spin), the fp
form and the int8 form with no slot, about half the slots and every slot
marked, each at three device spins before the timed call (to show the
host's enqueue never sets the time), and prints one JSON line per form
with the wrapper's host time per call beside, and each of the form's
three kernels' device time per call (scores, P·V, sum) from
``torch.profiler`` over 20 calls, each after an L2 flush (passes 2 and
3 start while the pass before them runs, so each span includes its
wait). First ptxas's register and spill lines of the build; last, the
card's name and power limit.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys
import subprocess
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch import profiling  # noqa: E402

SHARES = (("none", 0.0), ("half", 0.5), ("all", 1.01))
LEADS = (200_000, 1_000_000, 4_000_000)
PASSES = ("scores", "pv", "sum")      # paged_<pass>_kernel
PROFILED_CALLS = 20


def pass_ms(fn, flush) -> dict:
    """Device ms per call of each of the form's kernels, by pass."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    _, _, top = profiling.device_kernels(prof, ())
    return {f"{p}_ms": sum(k["device_ms"] for k in top
                           if f"paged_{p}_kernel" in k["name"])
            / PROFILED_CALLS for p in PASSES}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_int8: no CUDA device", file=sys.stderr)
        return 1
    for fn, line in smoke.ptxas_report(
            build.build(["paged_decode"])["paged_decode"]["log"]):
        print(f"ptxas[paged_decode] {fn} {line}", flush=True)
    dev = torch.device("cuda")
    q, k, v, phys, logical, kvl = smoke.paged_inputs(
        4, 16, 1, 128, 16, 64, 1024, (1024, 1000, 777, 500), 1, dev)
    scale = 1.0 / math.sqrt(128)
    flush = torch.empty(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    forms = {"fp": lambda: kpaged.paged_decode_attention(
        q, k, v, phys, logical, kvl, scale=scale)}
    for name, share in SHARES:
        tier = smoke.int8_tier(k, phys, 1, share=share)
        forms[f"int8_{name}"] = (
            lambda t=tier: kpaged.paged_decode_attention(
                q, k, v, phys, logical, kvl, scale=scale, quant=t))
    for name, fn in forms.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        out = {"form": name, "host_ms_per_call": host_ms}
        for lead in LEADS:
            smoke.HOST_LEAD_CYCLES = lead
            out[f"ms_spin_{lead}"] = smoke.time_ms(fn, flush=flush)
        smoke.HOST_LEAD_CYCLES = LEADS[0]
        out.update(pass_ms(fn, flush))
        print(json.dumps(out), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
