#!/usr/bin/env python3
"""K3's element-level sphere mask on a GPU, form by form, beside the
tile-level forms and SDPA under the same mask.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_k3_elem.py

At ``chip_smoke.py``'s phase-6 timed case (BH 16, T = S = 2048, d 128,
tiles 128, keep 4 of 16, strict and fast; the tiles the glue selects) it
times, with ``chip_smoke.time_ms`` (median of 50 launches, each after an
L2 flush and a device spin), each form of K3 through its C entry point:
the ``wgmma`` and ``mma_sync`` forms, each without and with the element
mask (each masked form's error against the plain version beside), and
SDPA over the gathered rows under the element mask. The difference
between a form with and without the mask is what the mask costs in that
form. ptxas's register and spill lines of each build first, then one
JSON line per mode, then one with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import dlzs as kdlzs  # noqa: E402
from repro_torch.kernels import sufa as ksufa  # noqa: E402

BH, T, D, BLOCK = 16, 2048, 128, 128


def forms(q, k, v, idx, valid, out, *, strict: bool, radius: float):
    """Each form of K3 as a call of its C entry point on the same
    inputs, with and without the element mask."""
    lib = build.load("sufa")
    keep = idx.shape[2]
    # no lse and no keep bits: the served forward's arguments
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), out.data_ptr(), None, None)
    scale = D ** -0.5
    mma = lib.sufa_mma_bf16
    mma.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    wg = lib.sufa_wgmma_bf16
    wg.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    mma.restype = wg.restype = ctypes.c_int

    def run(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: CUDA error {err}")
        return out
    return {
        f"{form}_{mask}": (lambda fn=fn, args=args: run(fn, *args))
        for form, fn, head in (
            ("mma_sync", mma, (BH, T, T, keep, BLOCK, BLOCK, D)),
            ("wgmma", wg, (BH, T, T, keep, D)))
        for mask, elem in (("tile", 0), ("elem", 1))
        for args in [(*ptrs, *head, 1, int(strict), elem, scale, radius)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_elem: no CUDA device", file=sys.stderr)
        return 1
    for name, info in build.build(["dlzs_block", "sufa"]).items():
        for fn, line in smoke.ptxas_report(info["log"]):
            print(f"ptxas[{name}] {fn} {line}", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    star = olmo_1b.config().star
    keep = dataclasses.replace(star, block_q=BLOCK,
                               block_kv=BLOCK).keep_blocks(T)
    q, k, v = smoke.prefill_inputs(BH, T, D, 2053, dev)
    scale = D ** -0.5
    raw = kdlzs.dlzs_block_scores(q, k, causal=True, scale=1.0,
                                  block_q=BLOCK, block_kv=BLOCK)
    idx, valid = ops.select_tiles(raw, keep, scale=scale, radius=star.radius,
                                  dtype=q.dtype)
    idx, valid = idx.contiguous(), valid.contiguous()   # the entry points'
    kg, vg, visible = ksufa.gather_selected(k, v, idx, valid, t=T,
                                            block_q=BLOCK, block_kv=BLOCK,
                                            causal=True)
    with smoke.fp32_summed_bf16_gemms():
        mask = ksufa.sphere_mask(q, kg, visible, scale=scale,
                                 radius=star.radius)
    n = BH * (T // BLOCK)
    qs = q.reshape(n, 1, BLOCK, D)
    ks, vs = (x.reshape(n, 1, keep * BLOCK, D) for x in (kg, vg))
    ms = mask.transpose(2, 3).reshape(n, 1, BLOCK, keep * BLOCK)
    for strict in (True, False):
        kw = dict(block_q=BLOCK, block_kv=BLOCK, causal=True, scale=scale,
                  strict=strict, elementwise=True, radius=star.radius)
        with smoke.fp32_summed_bf16_gemms():
            want = ksufa.sufa_reference(q, k, v, idx, valid, **kw)
        out = torch.empty_like(q)
        row = {"BH": BH, "T": T, "d": D, "block": BLOCK, "keep": keep,
               "strict": strict, "valid_tiles": int(valid.sum()),
               "sphere_kept_share": int(mask.sum()) / int(visible.sum())}
        for name, fn in forms(q, k, v, idx, valid, out, strict=strict,
                              radius=star.radius).items():
            got = fn().clone()
            if name.endswith("_elem"):
                row[f"{name}_max_abs_err"] = float(
                    (got.float() - want.float()).abs().max())
            row[f"{name}_ms"] = smoke.time_ms(fn, flush=flush)
        row["sdpa_elem_ms"] = smoke.time_ms(
            lambda: smoke.SDPA(qs, ks, vs, attn_mask=ms, scale=scale),
            flush=flush)
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
