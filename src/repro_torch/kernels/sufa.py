"""K3 — SU-FA, block-sparse flash attention over gathered tiles: the CUDA
kernel ``csrc/sufa.cu`` behind a checked wrapper, beside its plain
PyTorch version.

Replaces ``repro/kernels/sufa.py::sufa_attention`` (Pallas, TPU). Each
query tile attends to ``keep`` key/value tiles gathered beforehand in
descending predicted-max order, under an int8 or bool mask. ``strict``
keeps FA-2's exact online rescale; ``strict=False`` freezes the running
max at the first tile (the paper's descend-updating fast path). The
kernel is bound by the bytes of the gathered tiles and the mask; see the
source's header. Tensors on the CPU take the plain version; tensors on a
GPU launch the kernel (bf16) or raise. ``kernels.LAUNCHES["sufa"]``
counts launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import launch, ref
from repro_torch.kernels.ref import NEG_INF

MASK_DTYPES = (torch.int8, torch.uint8, torch.bool)


def _descend_reference(q, kg, vg, mask, *, scale: float) -> torch.Tensor:
    """The fast path's recurrence (``strict=False``), tile by tile as the
    TPU kernel runs it: the max is set by the first tile with a visible
    key and never rescaled."""
    bh, t, d = q.shape
    _, n_qt, keep, _, _ = kg.shape
    qt = q.reshape(bh, n_qt, t // n_qt, d).float()
    m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
    l = torch.zeros(qt.shape[:3], device=q.device)
    o = torch.zeros(qt.shape, device=q.device)
    for j in range(keep):
        s = torch.einsum("bqtd,bqcd->bqtc", qt, kg[:, :, j].float()) * scale
        s = s.masked_fill(mask[:, :, j] == 0, NEG_INF)
        m = torch.where(m <= NEG_INF / 2, s.amax(dim=-1), m)
        p = torch.exp(s - m[..., None]).masked_fill(s <= NEG_INF / 2, 0.0)
        l = l + p.sum(dim=-1)
        o = o + p @ vg[:, :, j].float()
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(bh, t, d).to(q.dtype)


def sufa_reference(q, kg, vg, mask, *, scale: float,
                   strict: bool) -> torch.Tensor:
    """The plain version: the exact masked softmax (``ref.sufa_ref``) for
    ``strict``, else the frozen-max recurrence."""
    if strict:
        return ref.sufa_ref(q, kg, vg, mask, scale=scale)
    return _descend_reference(q, kg, vg, mask, scale=scale)


def sufa_attention(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                   mask: torch.Tensor, *, scale: Optional[float] = None,
                   strict: bool = False) -> torch.Tensor:
    """q [BH, T, d]; kg/vg [BH, n_qt, keep, Bc, d] (gathered, descending
    order); mask [BH, n_qt, keep, Bq, Bc] (validity x causal x sphere)
    -> [BH, T, d] in q's dtype."""
    bh, t, d = q.shape
    _, n_qt, keep, bc, _ = kg.shape
    bq = t // n_qt
    scale = scale or (1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return sufa_reference(q, kg, vg, mask, scale=scale, strict=strict)
    name = "sufa"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, kg=kg, vg=vg)
    if kg.shape != (bh, n_qt, keep, bc, d) or vg.shape != kg.shape \
            or bq * n_qt != t or mask.shape != (bh, n_qt, keep, bq, bc):
        raise ValueError(f"{name}: q {tuple(q.shape)}, kg {tuple(kg.shape)},"
                         f" vg {tuple(vg.shape)}, mask {tuple(mask.shape)} "
                         f"do not describe one tiling")
    if mask.device != q.device or mask.dtype not in MASK_DTYPES \
            or not mask.is_contiguous():
        raise TypeError(f"{name}: mask must be a contiguous int8, uint8 or "
                        f"bool tensor on {q.device}")
    launch.check_head_dim(name, d)
    launch.check_tile(name, "block_q", bq)
    launch.check_tile(name, "block_kv", bc)
    if keep < 1:
        raise ValueError(f"{name}: keep must be at least 1")
    out = torch.empty_like(q)
    fn = launch.bind(name, "sufa_bf16",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch(name, fn, q.device, q.data_ptr(), kg.data_ptr(),
                  vg.data_ptr(), mask.data_ptr(), out.data_ptr(), bh, n_qt,
                  keep, bq, bc, d, int(strict), float(scale))
    return out
