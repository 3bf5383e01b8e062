"""Multi-head attention layer: GQA + RoPE + {dense | STAR-sparse} + paged KV.

PyTorch port of ``repro.models.attention``: full-sequence prefill (K4
flash, or the STAR pipeline's K2 -> SADS -> K3, both through
``kernels.ops``; causal, or not for an encoder), the page-aligned chunk
prefill (per sequence and batched varlen), one-token decode against the
paged pool, one-token decode against the dense slot cache (the dense
engine's), the spatial (sequence-sharded) forms of the chunk prefills
and the paged decode, and the encoder-decoder cross-attention.

Training differentiates ``apply_prefill`` (``star=None`` in train mode):
K4's wrapper is a ``torch.autograd.Function`` whose backward is K4's
backward kernel, and the GQA expansion sums dK/dV over each group.

Where the reference updates a donated cache functionally
(``cache.at[...].set``), the port writes the pool slab or the dense slab
IN PLACE (``Tensor.index_put_``): the slab the caller passes is the live
cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import dlzs
from repro_torch.core.dr_attention import _merge_stats as _merge_two_stats
from repro_torch.core.dr_attention import merge_shards
from repro_torch.core.sads import NEG_INF
from repro_torch.core.star_attention import STARConfig
from repro_torch.kernels import ops
from repro_torch.models import common


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_fraction: float = 1.0
    rope_theta: float = 1e4
    qkv_bias: bool = False
    causal: bool = True
    star: Optional[STARConfig] = None   # sparse mode (None = dense)
    chunk_sparse: bool = False   # DLZS page selection over gathered past
    #                              pages in later prefill chunks (needs star)
    lz_cache: bool = True        # keep int8 LZ codes of K in the KV cache
    dtype: torch.dtype = torch.bfloat16


def init(generator: torch.Generator, cfg: AttentionCfg, device=None,
         n_layers: Optional[int] = None):
    """Projection weights; ``n_layers`` stacks them on a leading axis (the
    reference's vmapped block init) so the stack is one tensor per leaf."""
    h, nh, nkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    lead = () if n_layers is None else (n_layers,)

    def w(fan_in, fan_out, shape):
        return common.truncated_normal_init(
            generator, lead + (fan_in, fan_out), 1.0, cfg.dtype, device,
            fan_in=fan_in).reshape(lead + shape)

    p = {"wq": w(h, nh * dh, (h, nh, dh)),
         "wk": w(h, nkv * dh, (h, nkv, dh)),
         "wv": w(h, nkv * dh, (h, nkv, dh)),
         "wo": w(nh * dh, h, (nh, dh, h))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (nh, dh), dtype=cfg.dtype, device=device)
        p["bk"] = torch.zeros(lead + (nkv, dh), dtype=cfg.dtype,
                              device=device)
        p["bv"] = torch.zeros(lead + (nkv, dh), dtype=cfg.dtype,
                              device=device)
    return p


def _project_qkv(params, cfg: AttentionCfg, x, positions):
    """x [B,S,H] -> q [B,S,nh,dh], k/v [B,S,nkv,dh] with RoPE applied."""
    b, s, h = x.shape
    q = (x @ params["wq"].reshape(h, -1)).reshape(b, s, cfg.n_heads,
                                                 cfg.head_dim)
    k = (x @ params["wk"].reshape(h, -1)).reshape(b, s, cfg.n_kv,
                                                 cfg.head_dim)
    v = (x @ params["wv"].reshape(h, -1)).reshape(b, s, cfg.n_kv,
                                                 cfg.head_dim)
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.rope_fraction > 0:
        q = common.apply_rope(q, positions, theta=cfg.rope_theta,
                              rotary_fraction=cfg.rope_fraction)
        k = common.apply_rope(k, positions, theta=cfg.rope_theta,
                              rotary_fraction=cfg.rope_fraction)
    return q, k, v


def _out_proj(params, y):
    """y [..., nh, dh] -> [..., H]."""
    nh, dh, h = params["wo"].shape
    return y.reshape(*y.shape[:-2], nh * dh) @ params["wo"].reshape(
        nh * dh, h)


def _repeat_kv(kv, n_rep: int):
    """[B,S,nkv,dh] -> [B,S,nkv*n_rep,dh] (GQA group expansion)."""
    if n_rep == 1:
        return kv
    return kv.repeat_interleave(n_rep, dim=2)


def _softmax_rows(sc):
    """Masked softmax over the last axis (NEG_INF entries weigh 0)."""
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def _dense_chunked(q, k, v, *, causal: bool, q_chunk: int, scale: float):
    """Chunked masked softmax: q [B,T,n,d], k/v [B,S,n,d] -> [B,T,n,d];
    the score matrix is [B,n,chunk,S], never [B,n,T,S]. The plain dense
    form (the reference's); ``apply_prefill`` runs K4 instead."""
    b, t, n, d = q.shape
    s = k.shape[1]
    chunk = min(q_chunk, t)
    if t % chunk:
        chunk = t  # single chunk for odd sizes
    kT = k.transpose(1, 2)                             # [B,n,S,d]
    vT = v.transpose(1, 2)
    kv_pos = torch.arange(s, device=q.device)
    outs = []
    for off in range(0, t, chunk):
        qc = q[:, off:off + chunk].transpose(1, 2)     # [B,n,chunk,d]
        sc = (qc @ kT.transpose(-1, -2)).float() * scale
        if causal:
            q_pos = off + torch.arange(chunk, device=q.device)
            sc = sc.masked_fill(kv_pos[None, :] > q_pos[:, None], NEG_INF)
        o = _softmax_rows(sc).to(q.dtype) @ vT
        outs.append(o.transpose(1, 2))                 # [B,chunk,n,d]
    return torch.cat(outs, dim=1)


def apply_prefill(params, cfg: AttentionCfg, x, positions, *,
                  make_cache: bool = False, cache_len: Optional[int] = None):
    """Full-sequence attention. x [B,S,H] -> (y [B,S,H], cache | None)."""
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    n_rep = cfg.n_heads // cfg.n_kv

    # one contiguous [B·nh, S, d] problem per layer (the kernels' layout);
    # GQA K/V expanded to n_heads
    qh, kh, vh = (t.transpose(1, 2).reshape(
        b * cfg.n_heads, s, cfg.head_dim).contiguous()
        for t in (q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)))
    if cfg.star is not None:
        # K2 -> SADS -> K3 (kernels/ops.py), what star_attention_scanq
        # computes per (batch, head)
        o = ops.star_attention_cfg(qh, kh, vh, cfg.star, causal=cfg.causal,
                                   scale=scale)
    else:
        o = ops.flash(qh, kh, vh, causal=cfg.causal, scale=scale)   # K4
    y = o.reshape(b, cfg.n_heads, s, cfg.head_dim).transpose(1, 2)
    out = _out_proj(params, y)

    cache = None
    if make_cache:
        pad = (cache_len or s) - s
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cache = {"k": kc, "v": vc}
        if cfg.lz_cache:
            cache["k_lz"] = dlzs.lz_pack(kc)
    return out, cache


def _chunk_cache(cfg: AttentionCfg, k, v):
    cache = {"k": k, "v": v}
    if cfg.lz_cache:
        cache["k_lz"] = dlzs.lz_pack(k)
    return cache


def _attend(qg, k_all, v_all, mask, scale):
    """Grouped masked softmax: qg [B,T,g,r,d], k/v [B,S,g,d], mask
    broadcastable to [B,g,r,T,S] -> [B,T,g,r,d]."""
    sc = torch.einsum("btgrd,bsgd->bgrts", qg, k_all).float() * scale
    sc = sc.masked_fill(~mask, NEG_INF)
    return torch.einsum("bgrts,bsgd->btgrd", _softmax_rows(sc).to(qg.dtype),
                        v_all)


def _page_sphere(s_hat, wp: int, page: int, own: int, radius: float):
    """The chunk-sparse page sphere: ``s_hat`` [B, g, r, T, Wp·page] holds
    the DLZS estimates over the gathered past rows (NEG_INF where masked).
    A row keeps a page when the page's best estimate lies within
    ``radius`` of that row's best over all its pages, so every key the
    row drops is estimated more than ``radius`` below its best (e^-radius
    of its largest softmax term, as far as the estimates are the scores).
    Returns the keep mask [B, g, r, T, Wp·page + own] (the ``own`` rows
    of the chunk itself always kept)."""
    lead = s_hat.shape[:-1]
    page_max = s_hat.reshape(*lead, wp, page).amax(dim=-1)    # [..., Wp]
    keep = page_max >= page_max.amax(dim=-1, keepdim=True) - radius
    keep = keep[..., None].expand(*lead, wp, page).reshape(*lead, wp * page)
    return torch.cat([keep, keep.new_ones(lead + (own,))], dim=-1)


def apply_prefill_chunk(params, cfg: AttentionCfg, x, positions, cache,
                        past_phys, past_logical, past_len):
    """Prefill one page-aligned chunk from a nonzero cache offset.

    x [B,C,H]; positions [B,C] absolute; cache k/v [P,page,nkv,dh] (this
    layer's pool slabs, read-only here); past_phys/past_logical [B,Wp]
    (-1 = pad); past_len [B]. Each chunk query attends to every past row
    plus the causal prefix of its own chunk. Returns (y, chunk_cache) with
    the chunk's K/V (+ LZ codes) in prefill layout [B,C,nkv,dh].
    """
    b, c, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    page = cache["k"].shape[1]
    dev = x.device

    safe = torch.clamp(past_phys, min=0).long()
    wp = past_phys.shape[1]
    sp = wp * page
    kg = cache["k"][safe].reshape(b, sp, cfg.n_kv, cfg.head_dim).to(q.dtype)
    vg = cache["v"][safe].reshape(b, sp, cfg.n_kv, cfg.head_dim).to(q.dtype)

    past_pos = (past_logical[:, :, None] * page
                + torch.arange(page, device=dev)[None, None, :]
                ).reshape(b, sp)
    past_ok = (past_logical[:, :, None] >= 0).expand(b, wp, page
                                                      ).reshape(b, sp)
    past_ok = past_ok & (past_pos < past_len[:, None])

    k_all = torch.cat([kg, k], dim=1)                  # [B, Sp+C, nkv, d]
    v_all = torch.cat([vg, v], dim=1)
    kv_pos = torch.cat([past_pos, positions], dim=1)
    kv_ok = torch.cat([past_ok, torch.ones((b, c), dtype=torch.bool,
                                           device=dev)], dim=1)

    n_rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, c, cfg.n_kv, n_rep, cfg.head_dim)
    mask = kv_ok[:, None, None, None, :] & \
        (kv_pos[:, None, None, None, :] <= positions[:, None, None, :, None])

    if cfg.star is not None and cfg.chunk_sparse and wp > 0:
        # DLZS sphere over the gathered PAST pages (the chunk's own causal
        # block stays dense), taken per (sequence, KV head, query head,
        # query) row over that row's own page maxima
        if "k_lz" in cache:
            khat = dlzs.lz_unpack(cache["k_lz"][safe], q.dtype)
            khat = khat.reshape(b, sp, cfg.n_kv, cfg.head_dim)
        else:
            khat = dlzs.pow2_quantize(kg)
        s_hat = torch.einsum("btgrd,bsgd->bgrts", qg, khat).float() * scale
        s_hat = s_hat.masked_fill(~mask[..., :sp], NEG_INF)
        mask = mask & _page_sphere(s_hat, wp, page, c, cfg.star.radius)

    o = _attend(qg, k_all, v_all, mask, scale)
    out = _out_proj(params, o.reshape(b, c, cfg.n_heads, cfg.head_dim))
    return out, _chunk_cache(cfg, k, v)


def _batch_past_rows(cfg: AttentionCfg, cache, past_phys, past_lane,
                     past_logical, past_len, dtype):
    """Flatten the shared past-page ARENA into one row buffer:
    (k [1, Wp*page, nkv, d], v likewise, seg, pos, ok [Wp*page])."""
    page = cache["k"].shape[1]
    wp = past_phys.shape[0]
    sp = wp * page
    safe = torch.clamp(past_phys, min=0).long()
    kg = cache["k"][safe].reshape(1, sp, cfg.n_kv, cfg.head_dim).to(dtype)
    vg = cache["v"][safe].reshape(1, sp, cfg.n_kv, cfg.head_dim).to(dtype)
    pos = (past_logical[:, None] * page
           + torch.arange(page, device=past_phys.device)[None, :]
           ).reshape(sp)
    seg = past_lane.repeat_interleave(page)
    ok = (past_logical[:, None] >= 0).expand(wp, page).reshape(sp)
    ok = ok & (pos < past_len[torch.clamp(seg, min=0).long()])
    return kg, vg, seg, pos, ok


def apply_prefill_chunk_batch(params, cfg: AttentionCfg, x, positions,
                              cache, pack_state):
    """Prefill MANY sequences' chunks in one flat varlen dispatch.

    x [1, B_tok, H]; positions [1, B_tok] absolute; cache k/v
    [P, page, nkv, dh] (pool slabs, read-only here); ``pack_state`` holds
    seg_ids [B_tok], the past arena past_phys/past_lane/past_logical [Wp]
    and past_len [S]. The mask composes lane match, validity and causality
    over absolute positions. Returns (y [1, B_tok, H], chunk_cache
    [1, B_tok, nkv, dh] + LZ codes).
    """
    b, t, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    seg_q = pack_state["seg_ids"]
    past_phys = pack_state["past_phys"]
    past_lane = pack_state["past_lane"]
    wp = past_phys.shape[0]
    page = cache["k"].shape[1]
    sp = wp * page

    kg, vg, seg_p, pos_p, ok_p = _batch_past_rows(
        cfg, cache, past_phys, past_lane, pack_state["past_logical"],
        pack_state["past_len"], q.dtype)

    k_all = torch.cat([kg, k], dim=1)                  # [1, Sp+B_tok, nkv, d]
    v_all = torch.cat([vg, v], dim=1)
    kv_seg = torch.cat([seg_p, seg_q])
    kv_pos = torch.cat([pos_p, positions[0]])
    kv_ok = torch.cat([ok_p, seg_q >= 0])

    n_rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, t, cfg.n_kv, n_rep, cfg.head_dim)
    mask = (kv_ok & (kv_seg[None, :] == seg_q[:, None]))[None, None, None] \
        & (kv_pos[None, None, None, None, :]
           <= positions[:, None, None, :, None])

    if cfg.star is not None and cfg.chunk_sparse and wp > 0:
        # Same per-row DLZS sphere as apply_prefill_chunk: the mask has
        # already restricted each row to its own lane's pages
        if "k_lz" in cache:
            khat = dlzs.lz_unpack(
                cache["k_lz"][torch.clamp(past_phys, min=0).long()], q.dtype)
            khat = khat.reshape(1, sp, cfg.n_kv, cfg.head_dim)
        else:
            khat = dlzs.pow2_quantize(kg)
        s_hat = torch.einsum("btgrd,bsgd->bgrts", qg, khat).float() * scale
        s_hat = s_hat.masked_fill(~mask[..., :sp], NEG_INF)
        mask = mask & _page_sphere(s_hat, wp, page, t, cfg.star.radius)

    o = _attend(qg, k_all, v_all, mask, scale)
    out = _out_proj(params, o.reshape(b, t, cfg.n_heads, cfg.head_dim))
    return out, _chunk_cache(cfg, k, v)


def apply_decode(params, cfg: AttentionCfg, x, cache, lengths):
    """One-token decode against a dense slot cache. x [B,1,H]; cache k/v
    [B,S_max,nkv,dh] (+ ``k_lz``; this layer's slab, written IN PLACE);
    lengths [B]. The new token's K/V land at position ``lengths`` (clamped
    into the slab, as the reference's ``dynamic_update_slice`` clamps a
    free slot's ever-growing length); attention covers [0, lengths].

    Grouped GQA: the R query heads of a KV head read its cache rows, never
    a copy repeated to n_heads. Plain PyTorch, as the reference leaves this
    path to XLA: ``star_decode`` with STAR on, else a masked softmax.
    Returns (y [B,1,H], the cache dict)."""
    from repro_torch.core.star_attention import star_decode

    b = x.shape[0]
    s_max = cache["k"].shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k_new, v_new = _project_qkv(params, cfg, x, lengths[:, None])

    # in place of the reference's per-sequence dynamic_update_slice
    idx = (torch.arange(b, device=x.device),
           torch.clamp(lengths.long(), max=s_max - 1))
    cache["k"].index_put_(idx, k_new[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_(idx, v_new[:, 0].to(cache["v"].dtype))
    if cfg.lz_cache and "k_lz" in cache:
        cache["k_lz"].index_put_(idx, dlzs.lz_pack(k_new)[:, 0])

    n_rep = cfg.n_heads // cfg.n_kv
    qg = q[:, 0].reshape(b, cfg.n_kv, n_rep, cfg.head_dim)  # [B,g,r,d]
    kc = cache["k"].transpose(1, 2)                       # [B,g,S,d]
    vc = cache["v"].transpose(1, 2)
    kv_len = lengths + 1

    if cfg.star is not None:
        lz = None
        if cfg.lz_cache and "k_lz" in cache:
            lz = cache["k_lz"].transpose(1, 2)[:, :, None]
        o = star_decode(qg, kc[:, :, None], vc[:, :, None], cfg.star,
                        length=kv_len[:, None, None], k_lz=lz, scale=scale)
    else:
        sc = torch.einsum("bgrd,bgsd->bgrs", qg, kc).float() * scale
        pos = torch.arange(s_max, device=x.device)
        sc = sc.masked_fill(pos[None, None, None, :]
                            >= kv_len[:, None, None, None], NEG_INF)
        o = torch.einsum("bgrs,bgsd->bgrd", _softmax_rows(sc).to(x.dtype),
                         vc)

    y = _out_proj(params, o.reshape(b, cfg.n_heads, cfg.head_dim))
    return y[:, None, :], cache


def apply_decode_paged(params, cfg: AttentionCfg, x, cache, lengths,
                       page_state):
    """One-token decode against a paged pool. x [B,1,H]; cache k/v
    [P,page,nkv,dh] (this layer's slab, written IN PLACE); lengths [B].

    ``page_state``: phys/logical [B,W] block-table rows of the hot pages
    (-1 = pad) and write_page/write_off [B], the new token's pool row. The
    new K/V row is written into the pool, then attention reads only the W
    hot pages (``kvcache.paged_attention.paged_decode``: the CUDA kernel
    on a GPU). With the int8 tier in the cache and a ``qmask`` [B, W] in
    ``page_state``, marked slots read their int8 rows. With an ``audit``
    key, the returned cache also carries ``audit_mass`` [B, W], the exact
    per-page softmax mass (obs.audit), read from the fp slab.
    """
    from repro_torch.kvcache import paged_attention as kv_paged

    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k_new, v_new = _project_qkv(params, cfg, x, lengths[:, None])

    # in place of the reference's donated .at[wp, woff].set(...)
    idx = (page_state["write_page"].long(), page_state["write_off"].long())
    cache["k"].index_put_(idx, k_new[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_(idx, v_new[:, 0].to(cache["v"].dtype))
    if cfg.lz_cache and "k_lz" in cache:
        cache["k_lz"].index_put_(idx, dlzs.lz_pack(k_new)[:, 0])

    new_cache = dict(cache)
    kv_len = (lengths + 1).to(torch.int32)
    if "audit" in page_state:
        new_cache["audit_mass"] = kv_paged.page_attention_mass(
            q[:, 0], cache["k"], page_state["phys"], page_state["logical"],
            kv_len, n_kv=cfg.n_kv, scale=scale)
    quant = None
    if "kq" in cache and "qmask" in page_state:
        # int8 cold-tier read path: the slots the backend marked read
        # their dequantized int8 rows (kvcache.quant)
        quant = {"kq": cache["kq"], "vq": cache["vq"],
                 "k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                 "qmask": page_state["qmask"]}
    o = kv_paged.paged_decode(
        q[:, 0], cache["k"], cache["v"], page_state["phys"],
        page_state["logical"], kv_len, n_kv=cfg.n_kv, scale=scale,
        quant=quant)
    y = _out_proj(params, o.reshape(b, cfg.n_heads, cfg.head_dim))
    return y[:, None, :], new_cache


# ---------------------------------------------------------------------------
# Spatial (sequence-sharded) attention: a partial (m, l, o) per shard,
# merged over the shards. The reference runs one shard's view of each
# function inside shard_map over a mesh axis; here every shard lives on one
# device, the shard axis leads each pool slab ([S, P, page, nkv, dh]) and
# page-state leaf, and the reference's pmax/psum (``_psum_merge_stats``)
# become ``merge_shards``'s max and shard-order sums over that axis.
# ``_merge_two_stats`` is the pairwise flash-state merge. Q/K/V project
# once (the reference computes them replicated, with the same numbers).
# ---------------------------------------------------------------------------

def _softmax_stats(sc, v, eq: str):
    """(m, l, o) of masked fp32 scores ``sc`` [..., T, S] against ``v``:
    P = exp(sc - m), 0 where masked, o = einsum(eq, P, fp32 v)."""
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    return m, p.sum(dim=-1), torch.einsum(eq, p, v.float())


def _spatial_out(params, cfg: AttentionCfg, m1, l1, o1, qg, k, v, mask_c,
                 scale, dtype):
    """Merge the shards' merged past state (m1, l1, o1) [B,g,r,T(,d)] with
    the chunk's own causal block (replicated compute, merged once), divide
    and project: y [B, T, H]."""
    b, t = qg.shape[:2]
    sc_c = torch.einsum("btgrd,bsgd->bgrts", qg, k).float() * scale
    sc_c = sc_c.masked_fill(~mask_c, NEG_INF)
    m2, l2, o2 = _softmax_stats(sc_c, v, "bgrts,bsgd->bgrtd")
    _, l, o = _merge_two_stats(m1, l1, o1, m2, l2, o2)
    o = o / torch.clamp(l, min=1e-30)[..., None]     # [B, g, r, T, d]
    y = o.permute(0, 3, 1, 2, 4).reshape(b, t, cfg.n_heads, cfg.head_dim)
    return _out_proj(params, y.to(dtype))


def _scatter_chunk(cfg: AttentionCfg, cache, chunk_phys, k, v) -> None:
    """Write a chunk's K/V rows (+ LZ codes) into the pages each shard owns,
    in place: ``chunk_phys`` [S, B, C // page] (SCRATCH where another shard
    owns the page, or where the page is shared)."""
    n_sh, b, n_pg = chunk_phys.shape
    sh = torch.arange(n_sh, device=chunk_phys.device)[:, None, None]
    at = (sh, chunk_phys.long())
    page = cache["k"].shape[2]

    def put(pool, rows):
        rows = rows.reshape(b, n_pg, page, *rows.shape[2:])
        pool[at] = rows.to(pool.dtype).expand(n_sh, *rows.shape)
    put(cache["k"], k)
    put(cache["v"], v)
    if cfg.lz_cache and "k_lz" in cache:
        put(cache["k_lz"], dlzs.lz_pack(k))


def apply_prefill_chunk_spatial(params, cfg: AttentionCfg, x, positions,
                                cache, page_state):
    """Prefill one page-aligned chunk of a sequence-sharded prompt.

    x [B,C,H]; positions [B,C]; cache k/v [S,P,page,nkv,dh] (this layer's
    sharded slabs); ``page_state``: past_phys/past_logical [S,B,Wp]
    (shard-LOCAL ids, GLOBAL logical pages; -1 = pad), chunk_phys
    [S,B,C//page] and past_len [B]. Each shard's partial (m, l, o) of the
    chunk queries against its past pages, all shards in one batched
    product, merges over the shards; the chunk's causal block is added
    once; the chunk's K/V rows are written in place into the pages their
    owner shards hold. Returns (y [B,C,H], the cache dict)."""
    b, c, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    page = cache["k"].shape[2]
    dev = x.device
    n_rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, c, cfg.n_kv, n_rep, cfg.head_dim)

    past_phys = page_state["past_phys"]
    past_logical = page_state["past_logical"]
    n_sh, _, wp = past_phys.shape
    sp = wp * page
    sh = torch.arange(n_sh, device=dev)[:, None, None]
    safe = torch.clamp(past_phys, min=0).long()
    kg = cache["k"][sh, safe].reshape(n_sh, b, sp, cfg.n_kv,
                                      cfg.head_dim).to(q.dtype)
    vg = cache["v"][sh, safe].reshape(n_sh, b, sp, cfg.n_kv,
                                      cfg.head_dim).to(q.dtype)
    past_pos = (past_logical[..., None] * page
                + torch.arange(page, device=dev)).reshape(n_sh, b, sp)
    past_ok = (past_logical[..., None] >= 0).expand(n_sh, b, wp, page
                                                    ).reshape(n_sh, b, sp)
    past_ok = past_ok & (past_pos < page_state["past_len"][None, :, None])
    sc_p = torch.einsum("btgrd,kbsgd->kbgrts", qg, kg).float() * scale
    mask_p = (past_ok[:, :, None, None, None, :]
              & (past_pos[:, :, None, None, None, :]
                 <= positions[None, :, None, None, :, None]))
    sc_p = sc_p.masked_fill(~mask_p, NEG_INF)
    m1, l1, o1 = merge_shards(*_softmax_stats(sc_p, vg,
                                              "kbgrts,kbsgd->kbgrtd"))

    mask_c = positions[:, None, None, None, :] \
        <= positions[:, None, None, :, None]
    out = _spatial_out(params, cfg, m1, l1, o1, qg, k, v, mask_c, scale,
                       x.dtype)
    _scatter_chunk(cfg, cache, page_state["chunk_phys"], k, v)
    return out, cache


def apply_prefill_chunk_batch_spatial(params, cfg: AttentionCfg, x,
                                      positions, cache, page_state):
    """Batched varlen chunk prefill over sequence-sharded pools.

    The flat chunk buffer of ``apply_prefill_chunk_batch`` (x [1,B_tok,H];
    seg_ids [B_tok]; past_len [S_lanes]) against each shard's slice of the
    past arena, past_phys/past_lane/past_logical [S,Wp]: every shard's
    partial (m, l, o) of every lane's queries, merged over the shards,
    then the flat segment-masked causal block added once; fresh rows go
    to the owner shards' pages through chunk_phys [S,1,B_tok//page].
    Returns (y [1,B_tok,H], the cache dict)."""
    b, t, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    page = cache["k"].shape[2]
    dev = x.device
    n_rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, t, cfg.n_kv, n_rep, cfg.head_dim)
    seg_q = page_state["seg_ids"]

    past_phys = page_state["past_phys"]
    past_logical = page_state["past_logical"]
    n_sh, wp = past_phys.shape
    sp = wp * page
    sh = torch.arange(n_sh, device=dev)[:, None]
    safe = torch.clamp(past_phys, min=0).long()
    kg = cache["k"][sh, safe].reshape(n_sh, sp, cfg.n_kv,
                                      cfg.head_dim).to(q.dtype)
    vg = cache["v"][sh, safe].reshape(n_sh, sp, cfg.n_kv,
                                      cfg.head_dim).to(q.dtype)
    pos_p = (past_logical[..., None] * page
             + torch.arange(page, device=dev)).reshape(n_sh, sp)
    seg_p = page_state["past_lane"].repeat_interleave(page, dim=1)
    ok_p = (past_logical[..., None] >= 0).expand(n_sh, wp, page
                                                 ).reshape(n_sh, sp)
    ok_p = ok_p & (pos_p < page_state["past_len"][
        torch.clamp(seg_p, min=0).long()])
    sc_p = torch.einsum("btgrd,ksgd->kbgrts", qg, kg).float() * scale
    mask_p = ((ok_p[:, None, :] & (seg_p[:, None, :] == seg_q[None, :, None]))
              [:, None, None, None]
              & (pos_p[:, None, None, None, None, :]
                 <= positions[None, :, None, None, :, None]))
    sc_p = sc_p.masked_fill(~mask_p, NEG_INF)
    m1, l1, o1 = merge_shards(*_softmax_stats(sc_p, vg,
                                              "kbgrts,ksgd->kbgrtd"))

    mask_c = ((seg_q >= 0) & (seg_q[None, :] == seg_q[:, None])
              )[None, None, None] \
        & (positions[:, None, None, None, :]
           <= positions[:, None, None, :, None])
    out = _spatial_out(params, cfg, m1, l1, o1, qg, k, v, mask_c, scale,
                       x.dtype)
    _scatter_chunk(cfg, cache, page_state["chunk_phys"], k, v)
    return out, cache


def apply_decode_spatial(params, cfg: AttentionCfg, x, cache, lengths,
                         page_state):
    """One-token decode against a sequence-sharded paged pool.

    x [B,1,H]; cache k/v [S,P,page,nkv,dh] (this layer's sharded slabs,
    written IN PLACE); lengths [B]. ``page_state``: phys/logical [S,B,W]
    (shard-LOCAL ids; ``logical`` holds GLOBAL page indices so positions
    stay exact), write_page/write_off [S,B] (SCRATCH on every shard but
    the new token's owner), optional qmask [S,B,W] (int8-tier slots) and
    ``audit``. The new K/V row lands in its owner shard's page; one call
    of K1's stats form gives every shard's partial (m, l, o) over its hot
    pages; the states merge over the shards (exact: DRAttention's
    combination), so the result equals one-pool paged decode whenever the
    hot sets cover every page.

    There is no host branch for a shard whose hot set is empty for every
    sequence (the reference's ``lax.cond``): the kernel's early exit gives
    it the neutral state (m = NEG_INF, l = 0) at no work, and asking on
    the host would cost a device sync per layer. With ``audit`` the cache
    also carries ``audit_mass`` [S,B,W], normalised over all shards.
    Returns (y [B,1,H], the cache dict)."""
    from repro_torch.kvcache import paged_attention as kv_paged

    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k_new, v_new = _project_qkv(params, cfg, x, lengths[:, None])

    wp = page_state["write_page"].long()
    sh = torch.arange(wp.shape[0], device=x.device)[:, None].expand_as(wp)
    idx = (sh, wp, page_state["write_off"].long())
    cache["k"].index_put_(idx, k_new[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_(idx, v_new[:, 0].to(cache["v"].dtype))
    if cfg.lz_cache and "k_lz" in cache:
        cache["k_lz"].index_put_(idx, dlzs.lz_pack(k_new)[:, 0])

    new_cache = dict(cache)
    kv_len = (lengths + 1).to(torch.int32)
    if "audit" in page_state:
        new_cache["audit_mass"] = kv_paged.page_attention_mass(
            q[:, 0], cache["k"], page_state["phys"], page_state["logical"],
            kv_len, n_kv=cfg.n_kv, scale=scale, sharded=True)
    quant = None
    if "kq" in cache and "qmask" in page_state:
        quant = {"kq": cache["kq"], "vq": cache["vq"],
                 "k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                 "qmask": page_state["qmask"]}
    m, l, o = kv_paged.paged_decode_stats(
        q[:, 0], cache["k"], cache["v"], page_state["phys"],
        page_state["logical"], kv_len, n_kv=cfg.n_kv, scale=scale,
        quant=quant)
    _, l, o = merge_shards(m, l, o)
    o = o / torch.clamp(l, min=1e-30)[..., None]       # [B, G, R, d]
    y = _out_proj(params, o.reshape(b, cfg.n_heads, cfg.head_dim).to(x.dtype))
    return y[:, None, :], new_cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder; seamless-m4t)
# ---------------------------------------------------------------------------

def cross_init(generator: torch.Generator, cfg: AttentionCfg, device=None,
               n_layers: Optional[int] = None):
    return init(generator, cfg, device, n_layers=n_layers)


def cross_encode(params, cfg: AttentionCfg, enc_out):
    """The encoder-side K/V, made once per layer (the cross-attention
    cache): enc_out [B,S,H] -> k/v [B,S,nkv,dh]."""
    b, s, h = enc_out.shape
    k = (enc_out @ params["wk"].reshape(h, -1)).reshape(b, s, cfg.n_kv,
                                                       cfg.head_dim)
    v = (enc_out @ params["wv"].reshape(h, -1)).reshape(b, s, cfg.n_kv,
                                                       cfg.head_dim)
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return {"k": k, "v": v}


def cross_apply(params, cfg: AttentionCfg, x, enc_cache):
    """Decoder cross-attention, no mask: x [B,T,H] against the cached
    encoder K/V [B,S,nkv,dh] -> [B,T,H]. A prefill (T > 1) runs K4
    non-causal over [B·nh, T, d] queries and the K/V expanded to n_heads,
    as ``apply_prefill`` does; a decode step (T = 1) the grouped plain
    softmax at n_kv width, as ``apply_decode`` does (the reference hands
    both to XLA)."""
    b, t, h = x.shape
    nh, dh = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(dh)
    q = (x @ params["wq"].reshape(h, -1)).reshape(b, t, nh, dh)
    if cfg.qkv_bias:
        q = q + params["bq"]
    k, v = (enc_cache[name].to(q.dtype) for name in ("k", "v"))
    n_rep = nh // cfg.n_kv
    if t == 1:
        qg = q[:, 0].reshape(b, cfg.n_kv, n_rep, dh)
        sc = torch.einsum("bgrd,bsgd->bgrs", qg, k).float() * scale
        o = torch.einsum("bgrs,bsgd->bgrd", _softmax_rows(sc).to(q.dtype),
                         v)
        y = o.reshape(b, 1, nh, dh)
    else:
        qh, kh, vh = (u.transpose(1, 2).reshape(b * nh, -1, dh).contiguous()
                      for u in (q, _repeat_kv(k, n_rep),
                                _repeat_kv(v, n_rep)))
        o = ops.flash(qh, kh, vh, causal=False, scale=scale)   # K4
        y = o.reshape(b, nh, t, dh).transpose(1, 2)
    return _out_proj(params, y)
