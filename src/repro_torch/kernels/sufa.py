"""K3 — SU-FA, block-sparse flash attention over the selected tiles: the
CUDA kernel ``csrc/sufa.cu`` behind a checked wrapper, beside its plain
PyTorch version.

Replaces ``repro/kernels/sufa.py::sufa_attention`` (Pallas, TPU). Each
query tile attends to ``keep`` key/value tiles in the order SADS ranked
them (descending predicted max). The TPU kernel takes those tiles
gathered beforehand, with a mask, because its static BlockSpecs cannot
follow tile ids; this one takes the ids (``idx``) and their validity and
reads the selected tiles of K and V in place, building the validity and
causal mask from positions. ``strict`` keeps FA-2's exact online rescale;
``strict=False`` freezes each row's running max at the first tile in
which it sees a key (the paper's descend-updating fast path). The kernel
is bound by the bytes of Q, the output and the distinct selected tiles;
see the source's header. Two forms, picked by shape alone
(``launch.tile_form``): ``wgmma`` + TMA for the served 128 x 128 tiles,
``mma_sync`` for other tiles (the pool probe's 16). ``elementwise`` adds
STAR's element-level sphere mask (``STARConfig(elementwise=True)``): a
key is dropped where its DLZS estimate, rounded as
``core.dlzs.dlzs_scores`` rounds it, lies more than ``radius`` below the
row's largest estimate over its visible selected keys; both forms carry
it (the ``wgmma`` form runs the estimates on ``wgmma`` as well).

The plain version (``sufa_reference``) gathers the selected tiles and
their mask (``gather_selected``, what the TPU contract's caller builds)
and runs the exact masked softmax or the frozen-max recurrence over them.
Tensors on the CPU take it; tensors on a GPU launch the kernel (bf16) or
raise. ``kernels.LAUNCHES["sufa"]`` counts launches,
``kernels.FORM_LAUNCHES`` each form's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.core.dlzs import pow2_quantize
from repro_torch.kernels import launch, ref
from repro_torch.kernels.ref import NEG_INF


def gather_selected(k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor, *, t: int, block_q: int,
                    block_kv: int, causal: bool):
    """The TPU contract's operands for tile ids ``idx`` / ``valid`` [BH,
    n_qt, keep]: the gathered K/V tiles [BH, n_qt, keep, Bc, d] and the
    validity x in-tile causal mask [BH, n_qt, keep, Bq, Bc] (queries are
    the last ``t`` of the S positions)."""
    bh, s, d = k.shape
    n_qt, keep = idx.shape[1], idx.shape[2]
    n_kt = s // block_kv
    rows = torch.arange(bh, device=k.device)[:, None, None]
    kg = k.reshape(bh, n_kt, block_kv, d)[rows, idx]
    vg = v.reshape(bh, n_kt, block_kv, d)[rows, idx]
    mask = valid[..., None, None]
    if causal:
        q_pos = (torch.arange(t, device=k.device) + (s - t)).reshape(
            n_qt, block_q)
        kv_pos = idx[..., None] * block_kv + torch.arange(block_kv,
                                                          device=k.device)
        mask = mask & (kv_pos[:, :, :, None, :]
                       <= q_pos[None, :, None, :, None])
    mask = mask.expand(bh, n_qt, keep, block_q, block_kv).contiguous()
    return kg, vg, mask


def _descend_reference(q, kg, vg, mask, *, scale: float) -> torch.Tensor:
    """The fast path's recurrence (``strict=False``), tile by tile as the
    TPU kernel runs it: each row's max is set by the first tile in which
    it sees a key and never rescaled."""
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


def sphere_mask(q, kg, mask, *, scale: float, radius: float
                ) -> torch.Tensor:
    """The element-level sphere on top of ``mask`` [BH, n_qt, keep, Bq,
    Bc]: keep a key where its DLZS estimate bf16(q · pow2(k)) · scale (in
    q's dtype, as ``core.dlzs.dlzs_scores``) is at least the row's largest
    estimate over its visible keys less ``radius`` (what
    ``core.star_attention.star_attention`` builds with ``elementwise``)."""
    bh, t, d = q.shape
    n_qt = kg.shape[1]
    qt = q.reshape(bh, n_qt, t // n_qt, d)
    est = torch.einsum("bqtd,bqjcd->bqjtc", qt, pow2_quantize(kg)) * scale
    est = est.masked_fill(~mask, NEG_INF)
    top = est.amax(dim=(2, 4), keepdim=True)
    return mask & (est >= top - radius)


def sufa_reference(q, k, v, idx, valid, *, block_q: int, block_kv: int,
                   causal: bool, scale: float, strict: bool,
                   elementwise: bool = False, radius: float = 5.0
                   ) -> torch.Tensor:
    """The plain version: gather the selected tiles and their mask (with
    ``elementwise``, the sphere's too), then the exact masked softmax
    (``ref.sufa_ref``) for ``strict``, else the frozen-max recurrence."""
    kg, vg, mask = gather_selected(k, v, idx, valid, t=q.shape[1],
                                   block_q=block_q, block_kv=block_kv,
                                   causal=causal)
    if elementwise:
        mask = sphere_mask(q, kg, mask, scale=scale, radius=radius)
    if strict:
        return ref.sufa_ref(q, kg, vg, mask, scale=scale)
    return _descend_reference(q, kg, vg, mask, scale=scale)


def sufa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   idx: torch.Tensor, valid: torch.Tensor, *,
                   block_q: int = 128, block_kv: int = 128,
                   causal: bool = True, scale: Optional[float] = None,
                   strict: bool = False, elementwise: bool = False,
                   radius: float = 5.0) -> torch.Tensor:
    """q [BH, T, d], k/v [BH, S, d] (the queries are the last T of the S
    positions); idx [BH, T/block_q, keep] key-tile ids in visiting order
    (descending predicted max), valid [BH, T/block_q, keep] bool
    -> [BH, T, d] in q's dtype. ``elementwise`` applies the element-level
    sphere of ``radius`` inside the selected tiles."""
    bh, t, d = q.shape
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return sufa_reference(q, k, v, idx, valid, block_q=block_q,
                              block_kv=block_kv, causal=causal, scale=scale,
                              strict=strict, elementwise=elementwise,
                              radius=radius)
    name = "sufa"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k, v=v)
    launch.check_head_dim(name, d)
    launch.check_tile(name, "block_q", block_q)
    launch.check_tile(name, "block_kv", block_kv)
    if k.dim() != 3 or v.shape != k.shape or k.shape[0] != bh \
            or k.shape[2] != d or t % block_q or s % block_kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} must be [BH,T,d] and [BH,S,d] "
                         f"with T, S multiples of the tiles {block_q} x "
                         f"{block_kv}")
    n_qt = t // block_q
    if idx.dim() != 3 or idx.shape[:2] != (bh, n_qt) or idx.shape[2] < 1 \
            or valid.shape != idx.shape:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and valid "
                         f"{tuple(valid.shape)} must both be [BH={bh}, "
                         f"n_qt={n_qt}, keep >= 1]")
    if idx.device != q.device or valid.device != q.device \
            or idx.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: idx must be int64 and valid bool, both "
                        f"on {q.device}")
    idx, valid = idx.contiguous(), valid.contiguous()
    keep = idx.shape[2]
    out = torch.empty_like(q)
    form = launch.tile_form(block_q, block_kv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), out.data_ptr())
    if form == "wgmma":
        fn = launch.bind(name, "sufa_wgmma_bf16",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, keep, d, int(causal), int(strict),
                int(elementwise), float(scale), float(radius))
    else:
        fn = launch.bind(name, "sufa_mma_bf16",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, keep, block_q, block_kv, d, int(causal),
                int(strict), int(elementwise), float(scale), float(radius))
    launch.launch(name, fn, q.device, *args, form=form, causal=causal)
    if elementwise:
        kernels.FORM_LAUNCHES[f"{name}/elementwise"] += 1
    return out
