"""Plain PyTorch versions of the prefill tile kernels, port of
``repro.kernels.ref``: dense masked softmax, fp32 statistics, no tiling;
K4's backward (``flash_bwd_ref``); and K1's split-and-merge in plain form
(``paged_decode_split_ref``).

The wrappers (``kernels.flash``, ``kernels.sufa``, ``kernels.dlzs``) use
them for tensors on the CPU, and the on-card checks hold each CUDA kernel
against them. They build the whole [BH, T, S] score matrix, so nothing
on the served path calls them on a card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.dlzs import pow2_quantize
from repro_torch.kernels.paged import split_ranges

NEG_INF = -1e30


def _causal_mask(t: int, s: int, device) -> torch.Tensor:
    """[T, S]: key j is visible to query i iff j <= i + (S - T)."""
    return (torch.arange(s, device=device)[None, :]
            <= torch.arange(t, device=device)[:, None] + (s - t))


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              return_lse: bool = False):
    """Dense softmax attention, fp32 statistics. q [BH,T,d] -> [BH,T,d];
    with ``return_lse`` also each row's fp32 log-sum-exp of the scaled
    scores [BH, T] (+inf on a row that sees no key)."""
    t, d = q.shape[1], q.shape[2]
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    sc = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        sc = sc.masked_fill(~_causal_mask(t, s, q.device), NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    total = p.sum(dim=-1, keepdim=True)
    l = torch.clamp(total, min=1e-30)
    o = torch.einsum("bts,bsd->btd", p / l, v.float()).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(total > 0, m + torch.log(l), torch.inf)[..., 0]
    return o, lse


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> tuple:
    """The gradient of ``flash_ref`` in fp32, by K4's backward steps:
    P = exp(scale·QKᵀ − lse) (0 where masked, and on a row with lse =
    +inf), D = rowsum(dO∘O), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − D),
    dQ = scale·dS·K, dK = scale·dSᵀ·Q. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    t, d = q.shape[1], q.shape[2]
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    sc = torch.einsum("btd,bsd->bts", qf, kf) * scale
    p = torch.exp(sc - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(t, s, q.device), 0.0)
    dv = torch.einsum("bts,btd->bsd", p, dof)
    dp = torch.einsum("btd,bsd->bts", dof, vf)
    dvec = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - dvec)
    dq = torch.einsum("bts,bsd->btd", ds, kf) * scale
    dk = torch.einsum("bts,btd->bsd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def sufa_ref(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
             mask: torch.Tensor, *, scale: Optional[float] = None
             ) -> torch.Tensor:
    """Masked softmax over gathered tiles. Shapes as ``kernels.sufa``."""
    bh, t, d = q.shape
    _, n_qt, keep, bc, _ = kg.shape
    bq = t // n_qt
    scale = scale or (1.0 / math.sqrt(d))
    qt = q.reshape(bh, n_qt, bq, d).float()
    sc = torch.einsum("bqtd,bqkcd->bqtkc", qt, kg.float()) * scale
    sc = sc.masked_fill(mask.transpose(2, 3) == 0, NEG_INF)
    sc = sc.reshape(bh, n_qt, bq, keep * bc)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    vflat = vg.reshape(bh, n_qt, keep * bc, d).float()
    o = torch.einsum("bqtc,bqcd->bqtd", p / l, vflat)
    return o.reshape(bh, t, d).to(q.dtype)


def dlzs_block_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                   scale: Optional[float] = None, block_q: int = 128,
                   block_kv: int = 128) -> torch.Tensor:
    """Predicted block maxima via the float-domain pow2 quantizer."""
    bh, t, d = q.shape
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    block_q = min(block_q, t)
    block_kv = min(block_kv, s)
    sc = torch.einsum("btd,bsd->bts", q.float(),
                      pow2_quantize(k).float()) * scale
    if causal:
        sc = sc.masked_fill(~_causal_mask(t, s, q.device), NEG_INF)
    n_qt, n_kt = t // block_q, s // block_kv
    sc = sc.reshape(bh, n_qt, block_q, n_kt, block_kv)
    return sc.amax(dim=(2, 4))


def paged_decode_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, phys: torch.Tensor,
                           logical: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: float, n_split: int
                           ) -> tuple[torch.Tensor, tuple]:
    """K1's algorithm in plain form. Each of ``n_split`` ranges of
    block-table slots (``kernels.paged.split_ranges``) gives its (m, l)
    over scores rounded to q's dtype, as ``paged_gather_decode`` rounds
    them; the ranges' (m, l) merge into the sequence's (M, L) in split
    order; each range then adds its o = sum of P·v with P = exp(s - M) / L
    rounded to q's dtype; the o's add in split order, a range with l = 0
    adding nothing. Sums in fp32. q [B,G,R,d]; pool [P,page,G,d];
    phys/logical [B,W]; kv_len [B]. Returns (out [B,G,R,d] in q's dtype,
    (m, l [S,B,G,R], o [S,B,G,R,d]))."""
    b, g, r, d = q.shape
    n_pages, page = k_pages.shape[0], k_pages.shape[1]
    rows = torch.arange(page, device=q.device)
    parts = []
    for w0, w1 in split_ranges(phys.shape[1], n_split):
        ph = phys[:, w0:w1].long().clamp(0, n_pages - 1)       # [B, n]
        lg = logical[:, w0:w1].long()
        kr = k_pages[ph].reshape(b, -1, g, d)          # [B, n·page, G, d]
        vr = v_pages[ph].float().reshape(b, -1, g, d)
        valid = ((lg[:, :, None] >= 0) & (lg[:, :, None] * page + rows
                                          < kv_len[:, None, None])
                 ).reshape(b, 1, 1, -1)
        sc = torch.einsum("bgrd,bsgd->bgrs", q.float(), kr.float())
        sc = sc.to(q.dtype).float() * scale
        sc = sc.masked_fill(~valid, NEG_INF)
        m = sc.amax(dim=-1)
        l = torch.exp(sc - m[..., None]).masked_fill(~valid, 0.0).sum(-1)
        parts.append((sc, valid, vr, m, l))
    m = torch.stack([p[3] for p in parts])
    l = torch.stack([p[4] for p in parts])
    live = l > 0
    mx = m.masked_fill(~live, NEG_INF).amax(dim=0)
    den = torch.zeros_like(mx)
    for s in range(n_split):                      # the kernel's order
        den = den + torch.where(live[s], l[s] * torch.exp(m[s] - mx), 0.0)
    den = torch.clamp(den, min=1e-30)
    o = torch.stack([torch.einsum(
        "bgrs,bsgd->bgrd", (torch.exp(sc - mx[..., None]) / den[..., None])
        .masked_fill(~valid, 0.0).to(q.dtype).float(), vr)
        for sc, valid, vr, _, _ in parts])
    out = torch.zeros_like(o[0])
    for s in range(n_split):
        out = out + torch.where(live[s][..., None], o[s], 0.0)
    return out.to(q.dtype), (m, l, o)
