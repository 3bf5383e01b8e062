"""DRAttention — Distributed Ring-flow Attention (paper §V-B1), PyTorch port
of ``repro.core.dr_attention``.

Q and KV are both partitioned along the sequence dim across shards; the
*query* sub-blocks rotate around a logical ring carrying their partial
softmax state (m_i, l_i, o_i), which is merged at every hop. After N hops
every Q sub-block has visited every KV shard and holds the exact global
softmax result.

The reference runs the ring as ``ppermute`` over a mesh axis inside
``shard_map``. The port keeps every shard on one device: the mesh axis
becomes a leading shard axis ``[n_shards, chunk, ...]``, one hop is one
batched step over every shard at once, and the rotation is an index
shift. ``distributed_decode_merge`` is the single-query form (the
flash-decoding (m, l, o) merge) the spatial decode path uses: its pmax /
psum become ``merge_shards``'s max and sums over the shard axis.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.sads import NEG_INF


def _local_attn_stats(q, k, v, *, scale, mask):
    """Unnormalized local attention over leading batch dims: q [..., T, d],
    k/v [..., S, d], mask broadcastable to [..., T, S] -> (m [..., T],
    l [..., T], o [..., T, d]), fp32."""
    sc = (q @ k.transpose(-1, -2)).float() * scale
    sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    return m, p.sum(dim=-1), p @ v.float()


def _merge_stats(m_a, l_a, o_a, m_b, l_b, o_b):
    """Combine two partial softmax states (the paper's m_i/l_i update);
    empty partitions (m == NEG_INF) contribute nothing."""
    m = torch.maximum(m_a, m_b)
    ea = torch.where(m_a <= NEG_INF / 2, 0.0, torch.exp(m_a - m))
    eb = torch.where(m_b <= NEG_INF / 2, 0.0, torch.exp(m_b - m))
    return m, l_a * ea + l_b * eb, o_a * ea[..., None] + o_b * eb[..., None]


def merge_shards(m, l, o):
    """Merge per-shard partial states stacked on axis 0 — m/l [S, ...],
    o [S, ..., d] — into the global state: the reference's pmax + two
    psums over the mesh axis. The sums run in shard order: a cumulative
    sum's last row, one pass along the axis, where ``sum`` would pick its
    own reduction tree. Empty shards (m == NEG_INF) contribute
    nothing."""
    m_g = m.amax(dim=0)
    w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_g))
    l_g = torch.cumsum(l * w, dim=0)[-1]
    o_g = torch.cumsum(o * w[..., None], dim=0)[-1]
    return m_g, l_g, o_g


def dr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 n_shards: int, causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Ring-flow attention over ``n_shards`` sequence shards.

    q/k/v: [S, d] global sequences (S a multiple of ``n_shards``), cut
    into contiguous chunks, shard i holding chunk i of each. At hop t the
    Q chunk c visits KV shard (c + t) % n, as the reference's ppermute
    ring moves it; its state merges hop by hop in that order. Returns
    [S, d] in q's dtype."""
    s, d = q.shape
    n = n_shards
    if s % n:
        raise ValueError(f"sequence {s} not a multiple of {n} shards")
    scale = scale or (1.0 / math.sqrt(d))
    chunk = s // n
    qc = q.reshape(n, chunk, d)
    kc = k.reshape(n, chunk, d)
    vc = v.reshape(n, chunk, d)
    pos = torch.arange(s, device=q.device).reshape(n, chunk)
    owners = torch.arange(n, device=q.device)
    m = torch.full((n, chunk), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((n, chunk), dtype=torch.float32, device=q.device)
    o = torch.zeros((n, chunk, d), dtype=torch.float32, device=q.device)
    for t in range(n):                    # the ring's hops, not per layer
        at = (owners + t) % n             # the KV shard each chunk visits
        if causal:
            mask = pos[at][:, None, :] <= pos[:, :, None]
        else:
            mask = torch.ones((n, chunk, chunk), dtype=torch.bool,
                              device=q.device)
        mh, lh, oh = _local_attn_stats(qc, kc[at], vc[at], scale=scale,
                                       mask=mask)
        m, l, o = _merge_stats(m, l, o, mh, lh, oh)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(s, d).to(q.dtype)


def distributed_decode_merge(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, n_shards: int, length,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-sharded single-query decode: a partial (m, l, o) per shard
    and one merge over the shard axis (``merge_shards``).

    q [d]; k/v [S, d] cut into ``n_shards`` contiguous chunks; ``length``
    is the valid prefix. Returns [d] in k's dtype."""
    s, d = k.shape
    n = n_shards
    if s % n:
        raise ValueError(f"sequence {s} not a multiple of {n} shards")
    scale = scale or (1.0 / math.sqrt(d))
    chunk = s // n
    pos = torch.arange(s, device=k.device).reshape(n, 1, chunk)
    m, l, o = _local_attn_stats(q.expand(n, 1, d), k.reshape(n, chunk, d),
                                v.reshape(n, chunk, d), scale=scale,
                                mask=pos < length)
    _, l_g, o_g = merge_shards(m, l, o)   # [1], [1, d]
    return (o_g[0] / torch.clamp(l_g[0], min=1e-30)).to(k.dtype)
