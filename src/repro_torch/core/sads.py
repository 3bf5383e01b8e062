"""SADS — Sphere-search Aided Distributed Sorting (paper §IV-B): element
selection for decode and tile selection for prefill; PyTorch port of
``repro.core.sads``.

A query tile keeps the top ``keep`` KV tiles ranked by predicted tile max;
a sphere of radius ``r`` around the row's best tile drops tiles whose
softmax contribution is provably below e^-r.

Ranking: ``jax.lax.top_k`` breaks ties toward the LOWER index, and
``torch.topk`` promises no tie order. pow2-quantized scores tie often and
causally masked tiles all equal NEG_INF, so the port ranks with a stable
descending sort and slices — the same order as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class SADSSelection(NamedTuple):
    """Element-level selection result (flattened over segments)."""

    indices: torch.Tensor  # [..., k_total] global column ids, segment-major
    valid: torch.Tensor    # [..., k_total] bool: in-sphere, not masked
    values: torch.Tensor   # [..., k_total] the survivors' estimated scores


def sads_select(scores: torch.Tensor, k_total: int, n_segments: int,
                radius: float = 5.0) -> SADSSelection:
    """Element-level SADS over the last axis (the decode path). scores
    [..., S] are estimated scores, already NEG_INF at masked positions;
    each of ``n_segments`` segments keeps its top k_total / n_segments
    (descending, ties to the lower index) inside a sphere of ``radius``
    around its own max."""
    s = scores.shape[-1]
    if s % n_segments:
        raise ValueError(f"S={s} not divisible by n_segments={n_segments}")
    if k_total % n_segments:
        raise ValueError(f"k={k_total} not divisible by "
                         f"n_segments={n_segments}")
    seg_len = s // n_segments
    k_seg = k_total // n_segments
    segs = scores.reshape(*scores.shape[:-1], n_segments, seg_len)
    vals, idx = top_k_lower_index_ties(segs, k_seg)  # [..., n, k/n]
    seg_max = vals[..., :1]                          # the sphere's centre
    valid = (vals >= (seg_max - radius)) & (vals > NEG_INF / 2)
    gidx = idx + (torch.arange(n_segments, device=scores.device)
                  * seg_len)[:, None]

    def flat(a):
        return a.reshape(*a.shape[:-2], k_total)
    return SADSSelection(flat(gidx), flat(valid), flat(vals))


def gather_selected(kv: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather selected rows: kv [..., S, d], indices [..., k] -> [..., k,
    d] (leading dims of ``kv`` broadcast against ``indices``')."""
    lead = torch.broadcast_shapes(kv.shape[:-2], indices.shape[:-1])
    kv = kv.expand(*lead, *kv.shape[-2:])
    idx = indices.expand(*lead, indices.shape[-1])
    return torch.gather(kv, -2, idx[..., None].expand(*idx.shape,
                                                      kv.shape[-1]))


class BlockSelection(NamedTuple):
    """Tile-level selection: per query tile, which KV tiles to visit."""

    block_idx: torch.Tensor    # [..., n_qt, keep] KV-tile ids, DESC by max
    block_valid: torch.Tensor  # [..., n_qt, keep] bool
    block_max: torch.Tensor    # [..., n_qt, keep] predicted tile max


def block_maxima(scores: torch.Tensor, block_q: int,
                 block_kv: int) -> torch.Tensor:
    """Predicted tile maxima: [..., T, S] -> [..., T/block_q, S/block_kv]."""
    *lead, t, s = scores.shape
    n_qt, n_kt = t // block_q, s // block_kv
    r = scores.reshape(*lead, n_qt, block_q, n_kt, block_kv)
    return r.amax(dim=(-3, -1))


def top_k_lower_index_ties(x: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sads_select_blocks(scores: torch.Tensor, block_q: int, block_kv: int,
                       keep: int, radius: float = 5.0,
                       causal: bool = False) -> BlockSelection:
    """Tile-level SADS: keep the top ``keep`` KV tiles per query tile, in
    descending predicted-max order (the SU-FA visit order)."""
    bmax = block_maxima(scores, block_q, block_kv)   # [..., n_qt, n_kt]
    n_qt, n_kt = bmax.shape[-2], bmax.shape[-1]
    if causal:
        qt = torch.arange(n_qt, device=bmax.device)[:, None]
        kt = torch.arange(n_kt, device=bmax.device)[None, :]
        # KV tile kt overlaps queries of tile qt iff kt*Bc <= qt*Bq + Bq - 1.
        vis = (kt * block_kv) <= (qt * block_q + block_q - 1)
        bmax = torch.where(vis, bmax, torch.full_like(bmax, NEG_INF))

    keep = min(keep, n_kt)
    vals, idx = top_k_lower_index_ties(bmax, keep)
    row_best = vals[..., :1]
    valid = (vals > NEG_INF / 2) & (vals >= row_best - radius)
    return BlockSelection(idx, valid, vals)


def gather_blocks(kv: torch.Tensor, block_idx: torch.Tensor,
                  block_kv: int) -> torch.Tensor:
    """Gather selected KV tiles: kv [..., S, d], block_idx [..., n_qt, keep]
    -> [..., n_qt, keep, block_kv, d]."""
    *lead, s, d = kv.shape
    tiles = kv.reshape(*lead, s // block_kv, block_kv, d)
    n_qt, keep = block_idx.shape[-2], block_idx.shape[-1]
    flat = block_idx.reshape(*block_idx.shape[:-2], n_qt * keep)
    g = tiles.index_select(-3, flat) if not lead else torch.gather(
        tiles, -3, flat[..., None, None].expand(
            *flat.shape, block_kv, d))
    return g.reshape(*lead, n_qt, keep, block_kv, d)
