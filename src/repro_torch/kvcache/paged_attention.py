"""Paged decode attention over block tables — PyTorch port of
``repro.kvcache.paged_attention``.

* ``paged_gather_decode`` — the plain version: index the hot pages out of
  the pool slab into a [B, W·page] working set, then one grouped-GQA
  masked softmax. The CPU path and the numerics oracle of the kernel.
* ``paged_decode`` — dispatch on the tensors' device: the plain version on
  the CPU, the hand-written CUDA kernel (``kernels.paged``) on a GPU. There
  is no fallback on a CUDA tensor: the kernel launches or raises.
* ``paged_decode_stats`` — the sequence-sharded decode's per-shard partial
  state (m, l, o) over a pool of S shards (slabs [S, P, page, nkv, d]),
  dispatched the same way: ``paged_gather_decode_stats`` over the folded
  shards on the CPU, K1's stats form on a GPU.

Both touch only the ``W`` hot pages the allocator selected, so decode
compute and memory traffic scale with the retained working set, not the
sequence length.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B, nh, d] -> [B, G, R, d] grouped per KV head."""
    b, nh, d = q.shape
    return q.reshape(b, n_kv, nh // n_kv, d)


def _row_valid(logical: torch.Tensor, kv_len: torch.Tensor, page: int
               ) -> torch.Tensor:
    """[B, W·page] validity: slot present (logical >= 0) and row < kv_len."""
    b, w = logical.shape
    row_pos = (logical[:, :, None] * page
               + torch.arange(page, device=logical.device)[None, None, :]
               ).reshape(b, w * page)
    valid = (logical[:, :, None] >= 0).expand(b, w, page).reshape(b, w * page)
    return valid & (row_pos < kv_len[:, None])


def _gather_hot(k_pages, v_pages, phys, logical, kv_len, quant=None):
    """Pull the hot pages into [B, S_hot, nkv, d] rows + validity mask.
    ``phys`` entries < 0 are padded slots (gather clipped to page 0, the
    scratch page, and masked out via ``logical``).

    ``quant`` (optional) is the int8 cold-tier read path: a dict with the
    tier slabs ``kq``/``vq`` [P, page, nkv, d] int8, per-page scales
    ``k_scale``/``v_scale`` [P] f32 and ``qmask`` [B, W] bool marking the
    gathered slots that hold quantized content. A marked slot reads
    ``(float(kq) * scale)`` rounded once to the pool's dtype; other slots
    read the fp slab bit for bit, so an all-False qmask is the fp path."""
    page = k_pages.shape[1]
    b, w = phys.shape
    safe = torch.clamp(phys, min=0).long()
    kg = k_pages[safe]                                 # [B, W, page, nkv, d]
    vg = v_pages[safe]
    if quant is not None:
        qm = quant["qmask"][:, :, None, None, None]
        ks = quant["k_scale"][safe][:, :, None, None, None]
        vs = quant["v_scale"][safe][:, :, None, None, None]
        kq = quant["kq"][safe].float()
        vq = quant["vq"][safe].float()
        kg = torch.where(qm, (kq * ks).to(kg.dtype), kg)
        vg = torch.where(qm, (vq * vs).to(vg.dtype), vg)
    kg = kg.reshape(b, w * page, *k_pages.shape[2:])
    vg = vg.reshape(b, w * page, *v_pages.shape[2:])
    return kg, vg, _row_valid(logical, kv_len, page)


def dequantized_slabs(k_pages: torch.Tensor, v_pages: torch.Tensor,
                      phys: torch.Tensor, quant) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Copies of the fp slabs in which every page that a slot ``quant``'s
    qmask marks names holds its tier rows as ``_gather_hot`` reads them,
    ``(float(code) * scale)`` rounded once to the slab's dtype. Where every
    slot naming a page reads it the same way (distinct pages, or a qmask
    set per page), the fp read of these slabs is the int8 read of the
    originals: K1's int8 lane must equal its fp form over them, bit for
    bit. A sharded pool (slabs [S, P, ...], tables [S, B, W], the tier as
    ``fold_tier`` takes it) is read folded, as the stats form reads it."""
    shape = k_pages.shape
    if phys.dim() == 3:
        k_pages, phys = fold_shards(k_pages, phys)
        v_pages = v_pages.reshape(k_pages.shape)
        quant = fold_tier(quant)
    pages = phys[quant["qmask"] & (phys >= 0)].long().unique()
    out = []
    for slab, codes, scale in ((k_pages, quant["kq"], quant["k_scale"]),
                               (v_pages, quant["vq"], quant["v_scale"])):
        slab = slab.clone()
        slab[pages] = (codes[pages].float()
                       * scale[pages][:, None, None, None]).to(slab.dtype)
        out.append(slab.view(shape))
    return out[0], out[1]


def _scores(q, kg, valid, n_kv, scale):
    qg = _group(q, n_kv)                               # [B, G, R, d]
    kc = kg.transpose(1, 2)                            # [B, G, S_hot, d]
    sc = torch.einsum("bgrd,bgsd->bgrs", qg, kc).float() * scale
    return sc.masked_fill(~valid[:, None, None, :], NEG_INF)


def fold_shards(k_pages: torch.Tensor, phys: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A sharded pool slab [S, P, ...] read as one pool [S·P, ...] (a view
    where the slab allows one), and block tables [S, B, W] of shard-local
    ids as [S·B, W] rows of that pool: shard s's ids offset by s·P,
    padding kept at -1. K1's stats form does the same in place."""
    s, p = k_pages.shape[:2]
    off = (torch.arange(s, device=phys.device, dtype=phys.dtype)
           * p)[:, None, None]
    flat = torch.where(phys >= 0, phys + off, phys)
    return (k_pages.reshape(s * p, *k_pages.shape[2:]),
            flat.reshape(-1, phys.shape[-1]))


def fold_tier(quant):
    """The int8 tier of a sharded pool ({kq, vq: [S, P, ...]; k_scale,
    v_scale: [S, P]; qmask: [S, B, W]}) read as ``fold_shards`` reads the
    slabs: [S·P, ...], [S·P] and [S·B, W], views that alias the tier (the
    kernel's operands must not be copies). None stays None."""
    if quant is None:
        return None
    return {name: t.view(-1, *t.shape[2:]) for name, t in quant.items()}


def paged_gather_decode(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, phys: torch.Tensor,
                        logical: torch.Tensor, kv_len: torch.Tensor, *,
                        n_kv: int, scale: Optional[float] = None,
                        quant=None) -> torch.Tensor:
    """Plain paged decode. q [B,nh,d]; k/v pages [P,page,nkv,d];
    phys/logical [B,W]; kv_len [B] -> [B,nh,d]. ``quant`` enables the
    int8 cold-tier read path (``_gather_hot``)."""
    b, nh, d = q.shape
    scale = scale or (1.0 / math.sqrt(d))
    kg, vg, valid = _gather_hot(k_pages, v_pages, phys, logical, kv_len,
                                quant)
    sc = _scores(q, kg, valid, n_kv, scale)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bgrs,bgsd->bgrd", (p / l).to(q.dtype),
                     vg.transpose(1, 2))
    return o.reshape(b, nh, d)


def paged_gather_decode_stats(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, phys: torch.Tensor,
                              logical: torch.Tensor, kv_len: torch.Tensor,
                              *, n_kv: int, scale: Optional[float] = None,
                              quant=None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Unnormalized partial-softmax state ``(m, l, o)`` — m/l [B,G,R] f32,
    o [B,G,R,d] f32 — of a paged decode step. A sequence with no valid
    row yields m = NEG_INF / l = 0 / o = 0, the merge's neutral element.
    ``quant`` as in ``paged_gather_decode``."""
    b, nh, d = q.shape
    scale = scale or (1.0 / math.sqrt(d))
    kg, vg, valid = _gather_hot(k_pages, v_pages, phys, logical, kv_len,
                                quant)
    sc = _scores(q, kg, valid, n_kv, scale)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    o = torch.einsum("bgrs,bgsd->bgrd", p, vg.transpose(1, 2).float())
    return m, p.sum(dim=-1), o


def page_attention_mass(q: torch.Tensor, k_pages: torch.Tensor,
                        phys: torch.Tensor, logical: torch.Tensor,
                        kv_len: torch.Tensor, *, n_kv: int,
                        scale: Optional[float] = None,
                        sharded: bool = False) -> torch.Tensor:
    """Exact per-page attention mass of one decode query (the audit probe):
    [B, W] f32, the softmax mass each gathered page receives, averaged over
    heads. V is never gathered.

    ``sharded`` is the sequence-sharded form (the reference's ``axis=``):
    k_pages [S, P, page, nkv, d] and phys/logical [S, B, W] (shard-local
    ids) give [S, B, W] masses, the softmax normalised over ALL shards
    (the reference's pmax/psum: a max and a shard-order sum over the
    shard axis), so each sequence's masses sum to 1 across the shards.
    A shard with no resident page gets zeros."""
    b, nh, d = q.shape
    scale = scale or (1.0 / math.sqrt(d))
    s = phys.shape[0] if sharded else 1
    if sharded:
        k_pages, phys = fold_shards(k_pages, phys)
        q = q.repeat(s, 1, 1)
        logical = logical.reshape(phys.shape)
        kv_len = kv_len.repeat(s)
    page = k_pages.shape[1]
    w = phys.shape[1]
    safe = torch.clamp(phys, min=0).long()
    kg = k_pages[safe].reshape(s * b, w * page, *k_pages.shape[2:])
    sc = _scores(q, kg, _row_valid(logical, kv_len, page), n_kv, scale)
    sc = sc.reshape(s, b, *sc.shape[1:])               # [S, B, G, R, rows]
    m = sc.amax(dim=-1).amax(dim=0)                    # [B, G, R]
    p = torch.exp(sc - m[..., None])
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.cumsum(p.sum(dim=-1), dim=0)[-1]         # shard order
    probs = p / torch.clamp(l, min=1e-30)[..., None]
    mass = probs.mean(dim=(2, 3))                      # head-averaged
    mass = mass.reshape(s, b, w, page).sum(dim=-1)     # [S, B, W]
    return mass if sharded else mass[0]


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, phys: torch.Tensor,
                 logical: torch.Tensor, kv_len: torch.Tensor, *,
                 n_kv: int, scale: Optional[float] = None,
                 quant=None) -> torch.Tensor:
    """Paged decode, dispatched on the tensors' device: the plain gather
    on the CPU, the CUDA kernel (``kernels.paged.paged_decode_attention``)
    on a GPU. q [B,nh,d] -> [B,nh,d] in q's dtype.

    The pool slabs go in their NATIVE layout [P, page, nkv, d]: the kernel
    reads a KV head's rows through strides. The JAX wrapper instead
    ``moveaxis``es both whole slabs to [nkv, P, page, d] on every call
    (repro/kvcache/paged_attention.py:245-247), because a Pallas BlockSpec
    tiles the trailing two axes; on the GPU that copy would move the
    entire pool twice per layer per decode tick, for nothing.

    ``quant`` (the int8 cold-tier read path, see ``_gather_hot``) follows
    the device too: the plain gather on the CPU, K1's int8 form on a GPU.
    The reference serves it through its XLA gather, its Pallas kernel
    having no dequant lane; here it never falls back to the gather.
    """
    from repro_torch.kernels.paged import paged_decode_attention
    b, nh, d = q.shape
    scale = scale or (1.0 / math.sqrt(d))
    o = paged_decode_attention(_group(q, n_kv), k_pages, v_pages, phys,
                               logical, kv_len, scale=scale, quant=quant)
    return o.reshape(b, nh, d)


def paged_decode_stats(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, phys: torch.Tensor,
                       logical: torch.Tensor, kv_len: torch.Tensor, *,
                       n_kv: int, scale: Optional[float] = None,
                       quant=None):
    """Per-shard partial decode state over a sequence-sharded pool,
    dispatched on the tensors' device: ``paged_gather_decode_stats`` over
    the folded shards on the CPU, K1's stats form
    (``kernels.paged.paged_decode_stats_attention``) on a GPU, one launch
    sequence for every shard. q [B,nh,d] (every shard's query); slabs
    [S,P,page,nkv,d]; phys/logical [S,B,W] shard-local; kv_len [B];
    ``quant`` the int8 tier with [S, ...] leaves and qmask [S,B,W].
    Returns m/l [S,B,G,R] and o [S,B,G,R,d], fp32."""
    from repro_torch.kernels.paged import paged_decode_stats_attention
    b, nh, d = q.shape
    scale = scale or (1.0 / math.sqrt(d))
    return paged_decode_stats_attention(_group(q, n_kv), k_pages, v_pages,
                                        phys, logical, kv_len, scale=scale,
                                        quant=quant)
