"""Plain PyTorch versions of the prefill tile kernels, port of
``repro.kernels.ref``: dense masked softmax, fp32 statistics, no tiling.

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

NEG_INF = -1e30


def _causal_mask(t: int, s: int, device) -> torch.Tensor:
    """[T, S]: key j is visible to query i iff j <= i + (S - T)."""
    return (torch.arange(s, device=device)[None, :]
            <= torch.arange(t, device=device)[:, None] + (s - t))


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Dense softmax attention, fp32 statistics. q [BH,T,d] -> [BH,T,d]."""
    t, d = q.shape[1], q.shape[2]
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    sc = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        sc = sc.masked_fill(~_causal_mask(t, s, q.device), NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bts,bsd->btd", p / l, v.float())
    return o.to(q.dtype)


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
