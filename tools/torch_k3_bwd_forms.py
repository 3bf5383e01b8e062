#!/usr/bin/env python3
"""K3's backward on a GPU, form by form: the ``wgmma`` + TMA passes and
the ``mma_sync`` kernels on the same inputs, beside SDPA's backward under
the same mask.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_k3_bwd_forms.py

At ``chip_smoke.py``'s phase-21a timed cases (OLMo-1B's training shape:
BH 128, T = S = 2048, d 128, causal; SeamlessM4T's encoder: BH 16, T = S
= 2048, d 64, not causal; tiles 128, keep 4 of 16, the tiles the glue
selects) it calls each form's C entry point (the ``mma_sync`` entry takes
tiles of 128 too, though the wrapper sends them to the ``wgmma`` form)
and times them with ``chip_smoke.time_ms`` (median of 50 launches, each
after an L2 flush and a device spin) in turns: mma_sync, wgmma, wgmma,
mma_sync; then each form's kernels by ``torch.profiler``
(``chip_smoke.flash_bwd_split``), the two forms' largest difference and
SDPA's backward under the selection's dense mask. ptxas's register and
spill lines first, then one JSON line per shape, then one with the
card's name and power limit.
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

BLOCK = 128
SHAPES = {"train": dict(bh=128, t=2048, d=128, causal=True, seed=2101),
          "encoder": dict(bh=16, t=2048, d=64, causal=False, seed=2102)}
MMA_KERNELS = ("sufa_grad_prep", "sufa_grad_kv", "sufa_grad_q")


def entries(q, k, v, idx, valid, o, lse, do, *, causal: bool):
    """Each form of K3's backward as a call of its C entry point on the
    same inputs, each writing its own dq, dk, dv."""
    lib = build.load("sufa_bwd")
    bh, t, d = q.shape
    keep = idx.shape[2]
    scale = d ** -0.5
    mma = lib.sufa_bwd_bf16
    mma.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    wg = lib.sufa_bwd_wgmma_bf16
    wg.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    mma.restype = wg.restype = ctypes.c_int
    fns = {}
    for form, fn, tail in (
            ("mma_sync", mma, (bh, t, t, keep, BLOCK, BLOCK, d, int(causal))),
            ("wgmma", wg, (bh, t, t, keep, d, int(causal)))):
        grads = [torch.empty_like(x) for x in (q, k, v)]
        scratch = torch.empty(2 * bh * t + 4, dtype=torch.float32,
                              device=q.device)
        ptrs = [x.data_ptr() for x in (q, k, v, idx, valid, o, lse, do,
                                       *grads, scratch)] + [None]

        def run(fn=fn, ptrs=ptrs, tail=tail, grads=grads):
            err = fn(*ptrs, *tail, scale,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K3 backward failed: CUDA error {err}")
            return grads
        fns[form] = run
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_bwd_forms: no CUDA device", file=sys.stderr)
        return 1
    for fn, line in smoke.ptxas_report(build.build(["sufa_bwd"])[
            "sufa_bwd"]["log"]):
        print(f"ptxas[sufa_bwd] {fn} {line}", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    star = olmo_1b.config().star
    for name, sh in SHAPES.items():
        bh, t, d, causal = sh["bh"], sh["t"], sh["d"], sh["causal"]
        q, k, v = smoke.prefill_inputs(bh, t, d, sh["seed"], dev)
        gen = torch.Generator(device="cpu").manual_seed(sh["seed"] + 2)
        do = torch.randn((bh, t, d), generator=gen).to(dev, torch.bfloat16)
        scale = d ** -0.5
        keep = dataclasses.replace(star, block_q=BLOCK,
                                   block_kv=BLOCK).keep_blocks(t)
        raw = kdlzs.dlzs_block_scores(q, k, causal=causal, scale=1.0,
                                      block_q=BLOCK, block_kv=BLOCK)
        idx, valid = ops.select_tiles(raw, keep, scale=scale,
                                      radius=star.radius, dtype=q.dtype)
        idx, valid = idx.contiguous(), valid.contiguous()
        o, lse = ksufa.sufa_attention(q, k, v, idx, valid, block_q=BLOCK,
                                      block_kv=BLOCK, causal=causal,
                                      strict=True, return_lse=True)
        fns = entries(q, k, v, idx, valid, o, lse, do, causal=causal)
        got = {form: [g.clone() for g in fn()] for form, fn in fns.items()}
        torch.cuda.synchronize()
        row = {"shape": name, "BH": bh, "T": t, "d": d, "causal": causal,
               "keep": keep, "valid_slots": int(valid.sum()),
               "selected_pairs": smoke.selected_pairs(
                   idx, valid, t=t, s=t, block=BLOCK, causal=causal),
               "forms_max_abs_diff": {
                   n: float((a.float() - b.float()).abs().max())
                   for n, a, b in zip(("dq", "dk", "dv"), got["mma_sync"],
                                      got["wgmma"])}}
        for i, form in enumerate(("mma_sync", "wgmma", "wgmma",
                                  "mma_sync")):
            row[f"{form}_ms_{i // 2}"] = smoke.time_ms(fns[form],
                                                       flush=flush)
        row["wgmma_split"] = smoke.flash_bwd_split(
            fns["wgmma"], flush, parts=smoke.SUFA_BWD_KERNELS)
        row["mma_sync_split"] = smoke.flash_bwd_split(
            fns["mma_sync"], flush, parts=MMA_KERNELS)
        dense = smoke.selection_mask(idx, valid, t=t, s=t, block_q=BLOCK,
                                     block_kv=BLOCK, causal=causal)
        leaves = [x.detach()[None].requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = smoke.SDPA(*leaves, attn_mask=dense[None],
                                  scale=scale)
        row["sdpa_backward_ms"] = smoke.time_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, do[None],
                                        retain_graph=True), flush=flush)
        print(json.dumps(row), flush=True)
        del sdpa_out, leaves, dense, got, fns
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
