"""Paged decode attention over block tables — PyTorch port of
``repro.kvcache.paged_attention``.

* ``paged_gather_decode`` — the plain version: index the hot pages out of
  the pool slab into a [B, W·page] working set, then one grouped-GQA
  masked softmax. The CPU path and the numerics oracle of the kernel.
* ``paged_decode`` — dispatch on the tensors' device: the plain version on
  the CPU, the hand-written CUDA kernel (``kernels.paged``) on a GPU. There
  is no fallback on a CUDA tensor: the kernel launches or raises.

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


def _scores(q, kg, valid, n_kv, scale):
    qg = _group(q, n_kv)                               # [B, G, R, d]
    kc = kg.transpose(1, 2)                            # [B, G, S_hot, d]
    sc = torch.einsum("bgrd,bgsd->bgrs", qg, kc).float() * scale
    return sc.masked_fill(~valid[:, None, None, :], NEG_INF)


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
                        scale: Optional[float] = None) -> torch.Tensor:
    """Exact per-page attention mass of one decode query (the audit probe):
    [B, W] f32, the softmax mass each gathered page receives, averaged over
    heads. V is never gathered."""
    b, nh, d = q.shape
    page = k_pages.shape[1]
    w = phys.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    safe = torch.clamp(phys, min=0).long()
    kg = k_pages[safe].reshape(b, w * page, *k_pages.shape[2:])
    sc = _scores(q, kg, _row_valid(logical, kv_len, page), n_kv, scale)
    m = sc.amax(dim=-1)                                # [B, G, R]
    p = torch.exp(sc - m[..., None])
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    probs = p / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    mass = probs.mean(dim=(1, 2))                      # head-averaged [B, S]
    return mass.reshape(b, w, page).sum(dim=-1)        # [B, W]


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
