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

``sufa_attention`` is differentiable, for STAR in training
(``ModelCfg.star_train``): where grad mode is on and q, k or v requires
grad it runs as ``_Sufa`` (a ``torch.autograd.Function``), whose forward
keeps the row log-sum-exp (both forms write it; the max cancels in
o / l, so the frozen-max recurrence gives the same lse) and whose
backward is ``sufa_bwd``: the gradient of the masked softmax over exactly
the keys the forward saw, the same for both ``strict`` modes. The TPU
kernel has no VJP (the reference differentiates ``core.sufa.
sufa_gathered`` or ``sufa_scan`` through XLA); on the card the backward
is ``csrc/sufa_bwd.cu`` (``kernels.LAUNCHES["sufa_bwd"]``), on the CPU
``sufa_bwd_ref``. The tile ids and their validity carry no gradient.
Like the forward, the backward has two forms, picked by
``launch.tile_form``: at the 128 x 128 tiles training runs, two
warp-specialised ``wgmma`` + TMA passes (dQ by q-tile over its slots,
summing D = rowsum(dO∘O) on the way; then dK and dV by key tile over the
q-tiles that chose it, in persistent blocks); ``mma_sync`` at tiles of 64
and the mixed ones (``FORM_LAUNCHES["sufa_bwd/<form>"]``). No sum crosses
a block, so two calls give the same bits.
The card's backward takes tiles of 64 or 128 without the element mask;
``_Sufa`` raises ``NotImplementedError`` on a CUDA tensor for the rest
(ROADMAP §1, item 7's remainder) and never runs the plain backward there.
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


def _descend_reference(q, kg, vg, mask, *, scale: float,
                       return_lse: bool = False):
    """The fast path's recurrence (``strict=False``), tile by tile as the
    TPU kernel runs it: each row's max is set by the first tile in which
    it sees a key and never rescaled. With ``return_lse`` also the row
    log-sum-exp m + log l [BH, T] (+inf on a row that sees no key): with
    the max frozen it is the same number as the exact one's."""
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
    out = out.reshape(bh, t, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.inf)
    return out, lse.reshape(bh, t)


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
                   elementwise: bool = False, radius: float = 5.0,
                   return_lse: bool = False):
    """The plain version: gather the selected tiles and their mask (with
    ``elementwise``, the sphere's too), then the exact masked softmax
    (``ref.sufa_ref``) for ``strict``, else the frozen-max recurrence;
    with ``return_lse`` also the fp32 row log-sum-exp [BH, T]."""
    kg, vg, mask = gather_selected(k, v, idx, valid, t=q.shape[1],
                                   block_q=block_q, block_kv=block_kv,
                                   causal=causal)
    if elementwise:
        mask = sphere_mask(q, kg, mask, scale=scale, radius=radius)
    if strict:
        return ref.sufa_ref(q, kg, vg, mask, scale=scale,
                            return_lse=return_lse)
    return _descend_reference(q, kg, vg, mask, scale=scale,
                              return_lse=return_lse)


def sufa_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor, *, block_q: int,
                 block_kv: int, causal: bool, scale: Optional[float] = None,
                 elementwise: bool = False, radius: float = 5.0) -> tuple:
    """The gradient of K3's function in fp32: the masked softmax over
    exactly the keys its forward saw (the selected tiles' validity, the
    in-tile causal mask at offset S − T and, with ``elementwise``, the
    element sphere), by K4's backward steps over the gathered tiles:
    P = exp(scale·q·kᵀ − lse) (0 where masked, and on a row with lse =
    +inf), D = rowsum(dO∘O), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − D),
    dQ = scale·dS·K, dK = scale·dSᵀ·Q. Each tile's dK and dV are added
    back into [BH, S, d] in a fixed order (ascending q-tile, then slot);
    keys that no q-tile selected get exact zeros. The strict and the fast
    forward compute the same function, so they share it. Returns (dq, dk,
    dv) in the dtypes of q, k, v."""
    bh, t, d = q.shape
    s = k.shape[1]
    n_qt, keep = idx.shape[1], idx.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    kg, vg, mask = gather_selected(k, v, idx, valid, t=t, block_q=block_q,
                                   block_kv=block_kv, causal=causal)
    if elementwise:
        mask = sphere_mask(q, kg, mask, scale=scale, radius=radius)
    qt = q.reshape(bh, n_qt, block_q, d).float()
    dot = do.reshape(bh, n_qt, block_q, d).float()
    kf, vf = kg.float(), vg.float()
    sc = torch.einsum("bqtd,bqjcd->bqjtc", qt, kf) * scale
    p = torch.exp(sc - lse.float().reshape(bh, n_qt, 1, block_q, 1))
    p = p.masked_fill(~mask, 0.0)
    dvec = (dot * o.reshape(bh, n_qt, block_q, d).float()).sum(dim=-1)
    dvg = torch.einsum("bqjtc,bqtd->bqjcd", p, dot)
    dp = torch.einsum("bqtd,bqjcd->bqjtc", dot, vf)
    ds = p * (dp - dvec[:, :, None, :, None])
    dq = torch.einsum("bqjtc,bqjcd->bqtd", ds, kf) * scale
    dkg = torch.einsum("bqjtc,bqtd->bqjcd", ds, qt) * scale
    dk = torch.zeros((bh, s // block_kv, block_kv, d), device=q.device)
    dv = torch.zeros_like(dk)
    rows = torch.arange(bh, device=q.device)
    for i in range(n_qt):           # one (head, tile) pair per row: no
        for j in range(keep):       # index repeats within one update
            dk[rows, idx[:, i, j]] += dkg[:, i, j]
            dv[rows, idx[:, i, j]] += dvg[:, i, j]
    return (dq.reshape(bh, t, d).to(q.dtype), dk.reshape(bh, s, d).to(k.dtype),
            dv.reshape(bh, s, d).to(v.dtype))


def _check(name: str, q, k, v, idx, valid, block_q: int, block_kv: int
           ) -> None:
    """The CUDA kernels' operand checks (K3's forward and backward)."""
    bh, t, d = q.shape
    s = k.shape[1]
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


def _forward(q, k, v, idx, valid, *, block_q: int, block_kv: int,
             causal: bool, scale: float, strict: bool, elementwise: bool,
             radius: float, with_lse: bool):
    """One forward call: o, or (o, lse [BH, T] fp32) ``with_lse``."""
    if q.device.type == "cpu":
        return sufa_reference(q, k, v, idx, valid, block_q=block_q,
                              block_kv=block_kv, causal=causal, scale=scale,
                              strict=strict, elementwise=elementwise,
                              radius=radius, return_lse=with_lse)
    name = "sufa"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k, v=v)
    _check(name, q, k, v, idx, valid, block_q, block_kv)
    bh, t, d = q.shape
    s = k.shape[1]
    idx, valid = idx.contiguous(), valid.contiguous()
    keep = idx.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    form = launch.tile_form(block_q, block_kv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    if form == "wgmma":
        fn = launch.bind(name, "sufa_wgmma_bf16",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, keep, d, int(causal), int(strict),
                int(elementwise), float(scale), float(radius))
    else:
        fn = launch.bind(name, "sufa_mma_bf16",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, keep, block_q, block_kv, d, int(causal),
                int(strict), int(elementwise), float(scale), float(radius))
    launch.launch(name, fn, q.device, *args, form=form, causal=causal)
    if elementwise:
        kernels.FORM_LAUNCHES[f"{name}/elementwise"] += 1
    return (out, lse) if with_lse else out


BWD_TILES = (64, 128)     # tiles the card's backward takes


def _require_card_backward(block_q: int, block_kv: int,
                           elementwise: bool) -> None:
    """Raise where the card's backward does not cover the case: tiles
    other than ``BWD_TILES``, or the element mask."""
    if elementwise or block_q not in BWD_TILES or block_kv not in BWD_TILES:
        raise NotImplementedError(
            f"sufa_bwd: the card's backward takes tiles of {BWD_TILES} "
            f"without the element mask; got {block_q} x {block_kv}, "
            f"elementwise={elementwise} (ROADMAP §1, item 7's remainder)")


def sufa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             idx: torch.Tensor, valid: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, do: torch.Tensor, *, block_q: int = 128,
             block_kv: int = 128, causal: bool = True,
             scale: Optional[float] = None, elementwise: bool = False,
             radius: float = 5.0) -> tuple:
    """K3's gradient: (dq, dk, dv) of ``sufa_attention(q, k, v, idx,
    valid)`` for the output gradient ``do`` [BH, T, d], given the
    forward's output ``o`` and fp32 ``lse`` [BH, T]; the same for both
    ``strict`` modes. CPU tensors take ``sufa_bwd_ref``; on a GPU the
    kernel runs (bf16 operands, contiguous; tiles of 64 or 128, no element
    mask) in the form its tiles pick (``launch.tile_form``) or this
    raises."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return sufa_bwd_ref(q, k, v, idx, valid, o, lse, do,
                            block_q=block_q, block_kv=block_kv,
                            causal=causal, scale=scale,
                            elementwise=elementwise, radius=radius)
    name = "sufa_bwd"
    launch.require_cuda(name, q.device)
    _require_card_backward(block_q, block_kv, elementwise)
    launch.check_operands(name, q=q, k=k, v=v, o=o, do=do)
    _check(name, q, k, v, idx, valid, block_q, block_kv)
    bh, t, d = q.shape
    s = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, t) \
            or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"{name}: o, do must be [BH,T,d] like q and lse "
                         f"fp32 contiguous [BH,T] on {q.device}; got o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}")
    idx, valid = idx.contiguous(), valid.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D and lse in base 2 per row, then the wgmma form's work counter
    scratch = torch.empty(2 * bh * t + 4, dtype=torch.float32,
                          device=q.device)
    ptrs = [x.data_ptr() for x in (q, k, v, idx, valid, o, lse, do, dq, dk,
                                   dv, scratch)]
    keep = idx.shape[2]
    form = launch.tile_form(block_q, block_kv)
    if form == "wgmma":
        fn = launch.bind(name, "sufa_bwd_wgmma_bf16",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
        args = (bh, t, s, keep, d, int(causal), float(scale))
    else:
        fn = launch.bind(name, "sufa_bwd_bf16",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
        args = (bh, t, s, keep, block_q, block_kv, d, int(causal),
                float(scale))
    launch.launch(name, fn, q.device, *ptrs, *args, form=form,
                  causal=causal)
    return dq, dk, dv


class _Sufa(torch.autograd.Function):
    """K3 with its gradient: the forward saves q, k, v, o, the row
    log-sum-exp and the selection; the backward is ``sufa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, idx, valid, kw: dict):
        if q.device.type != "cpu":
            _require_card_backward(kw["block_q"], kw["block_kv"],
                                   kw["elementwise"])
        o, lse = _forward(q, k, v, idx, valid, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, idx, valid, o, lse)
        # both modes compute one function: the backward takes no `strict`
        ctx.kw = {name: x for name, x in kw.items() if name != "strict"}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, idx, valid, o, lse = ctx.saved_tensors
        dq, dk, dv = sufa_bwd(q, k, v, idx, valid, o, lse, do.contiguous(),
                              **ctx.kw)
        return dq, dk, dv, None, None, None


def sufa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   idx: torch.Tensor, valid: torch.Tensor, *,
                   block_q: int = 128, block_kv: int = 128,
                   causal: bool = True, scale: Optional[float] = None,
                   strict: bool = False, elementwise: bool = False,
                   radius: float = 5.0, return_lse: bool = False):
    """q [BH, T, d], k/v [BH, S, d] (the queries are the last T of the S
    positions); idx [BH, T/block_q, keep] key-tile ids in visiting order
    (descending predicted max), valid [BH, T/block_q, keep] bool
    -> [BH, T, d] in q's dtype; with ``return_lse`` also the fp32 row
    log-sum-exp [BH, T] (natural base, +inf on a row that sees no key;
    not differentiable). ``elementwise`` applies the element-level sphere
    of ``radius`` inside the selected tiles. Differentiable in q, k and v
    (``_Sufa``) where grad mode is on and one of them requires grad."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    kw = dict(block_q=block_q, block_kv=block_kv, causal=causal,
              scale=scale, strict=strict, elementwise=elementwise,
              radius=radius)
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if return_lse:
        if needs_grad:
            raise ValueError("sufa_attention: return_lse is not "
                             "differentiable")
        return _forward(q, k, v, idx, valid, with_lse=True, **kw)
    if needs_grad:
        return _Sufa.apply(q, k, v, idx, valid, kw)
    return _forward(q, k, v, idx, valid, with_lse=False, **kw)
