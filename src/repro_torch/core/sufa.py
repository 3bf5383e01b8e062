"""SU-FA — Sorted-Updating FlashAttention (paper §IV-C), PyTorch port of
``repro.core.sufa``.

Tiles arrive in DESCENDING predicted-max order (from SADS), so after the
first tile the running max (almost) never changes:

  * ``sufa_scan``     — the streaming recurrence over the ``keep`` tiles;
                        ``strict=True`` keeps the exact FA-2 rescale,
                        ``strict=False`` freezes the max at tile 0 and
                        skips the rescale (the paper's fast path).
  * ``sufa_gathered`` — one masked softmax over the gathered tiles; equal
                        to the strict scan, the form the model layers use.

The scan's sequential loop is a Python loop over ``keep`` here; every
query tile advances in the same step (the reference vmaps over them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.sads import NEG_INF, BlockSelection, gather_blocks


class AttnState(NamedTuple):
    m: torch.Tensor  # [rows] running max (fp32)
    l: torch.Tensor  # [rows] running denominator (fp32)
    o: torch.Tensor  # [rows, d] unnormalized accumulator (fp32)


def sufa_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sel: BlockSelection, *, scale: float, block_q: int,
              block_kv: int, strict: bool = True,
              elem_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming SU-FA over one head. q [T,d], k/v [S,d] -> [T,d].

    ``sel.block_idx`` [n_qt, keep] is in descending predicted-max order;
    ``elem_mask`` (optional) is [n_qt, keep, block_q, block_kv].
    """
    t, d = q.shape
    s = k.shape[0]
    n_qt = t // block_q
    keep = sel.block_idx.shape[-1]
    k_tiles = k.reshape(s // block_kv, block_kv, d)
    v_tiles = v.reshape(s // block_kv, block_kv, d)
    q_tiles = q.reshape(n_qt, block_q, d)

    st = AttnState(
        torch.full((n_qt, block_q), NEG_INF, device=q.device),
        torch.zeros((n_qt, block_q), device=q.device),
        torch.zeros((n_qt, block_q, d), device=q.device))
    for j in range(keep):
        kv_id = sel.block_idx[:, j]                         # [n_qt]
        sc = torch.einsum("qtd,qcd->qtc", q_tiles,
                          k_tiles[kv_id]).float() * scale   # [n_qt, Bq, Bc]
        if elem_mask is not None:
            sc = sc.masked_fill(~elem_mask[:, j], NEG_INF)
        sc = sc.masked_fill(~sel.block_valid[:, j, None, None], NEG_INF)
        tile_max = sc.amax(dim=-1)                          # [n_qt, Bq]
        if strict:
            m_new = torch.maximum(st.m, tile_max)
            alpha = torch.exp(st.m - m_new)                 # ==1 when sorted
        else:
            # Descend updating: freeze the max established by tile 0.
            m_new = torch.where(st.m <= NEG_INF / 2, tile_max, st.m)
            alpha = torch.ones_like(st.m)                   # no rescale
        p = torch.exp(sc - m_new[..., None])
        p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
        st = AttnState(
            m_new,
            st.l * alpha + p.sum(dim=-1),
            st.o * alpha[..., None] + p @ v_tiles[kv_id].float())
    out = st.o / torch.clamp(st.l, min=1e-30)[..., None]
    return out.reshape(t, d).to(q.dtype)


def sufa_gathered(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sel: BlockSelection, *, scale: float, block_q: int,
                  block_kv: int, elem_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One-shot masked softmax over gathered selected tiles (model path).
    FLOPs: 4·T·keep·Bc·d — the sparse count; the full S never appears."""
    t, d = q.shape
    n_qt = t // block_q
    keep = sel.block_idx.shape[-1]
    kg = gather_blocks(k, sel.block_idx, block_kv)   # [n_qt, keep, Bc, d]
    vg = gather_blocks(v, sel.block_idx, block_kv)
    qt = q.reshape(n_qt, block_q, d)
    sc = torch.einsum("qtd,qkcd->qtkc", qt, kg).float() * scale
    sc = sc.masked_fill(~sel.block_valid[:, None, :, None], NEG_INF)
    if elem_mask is not None:
        # elem_mask convention: [n_qt, keep, Bq, Bc] -> [n_qt, Bq, keep, Bc]
        sc = sc.masked_fill(~elem_mask.transpose(1, 2), NEG_INF)
    sc = sc.reshape(n_qt, block_q, keep * block_kv)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    # P.V in the model dtype (stats stay fp32), as the reference does
    vg = vg.reshape(n_qt, keep * block_kv, d)
    out = torch.einsum("qtc,qcd->qtd", (p / l).to(q.dtype), vg)
    return out.reshape(t, d).to(q.dtype)
