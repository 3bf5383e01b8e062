"""Multi-head attention layer: GQA + RoPE + {dense | STAR-sparse} + paged KV.

PyTorch port of the attention-only subset of ``repro.models.attention``:
full-sequence prefill (K4 flash, or the STAR pipeline's K2 -> SADS -> K3,
both through ``kernels.ops``), the page-aligned chunk prefill (per
sequence and batched varlen), one-token decode against the paged pool,
and one-token decode against the dense slot cache (the dense engine's).
Cross-attention and the spatial (sequence-sharded) forms are later
slices (ROADMAP §1).

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
        # block stays dense); see the reference for the derivation.
        if "k_lz" in cache:
            khat = dlzs.lz_unpack(cache["k_lz"][safe], q.dtype)
            khat = khat.reshape(b, sp, cfg.n_kv, cfg.head_dim)
        else:
            khat = dlzs.pow2_quantize(kg)
        s_hat = torch.einsum("btgrd,bsgd->bgrts", qg, khat).float() * scale
        s_hat = s_hat.masked_fill(~mask[..., :sp], NEG_INF)
        page_max = s_hat.reshape(b, cfg.n_kv, n_rep, c, wp, page
                                 ).amax(dim=(1, 2, 3, 5))       # [B, Wp]
        row_max = page_max.amax(dim=-1, keepdim=True)
        keep = page_max >= row_max - cfg.star.radius            # sphere
        keep_rows = keep[:, :, None].expand(b, wp, page).reshape(b, sp)
        keep_all = torch.cat([keep_rows, torch.ones(
            (b, c), dtype=torch.bool, device=dev)], dim=1)
        mask = mask & keep_all[:, None, None, None, :]

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
    s_lanes = pack_state["past_len"].shape[0]

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
        # Same DLZS sphere as apply_prefill_chunk, per lane against a
        # segmented per-lane row max.
        if "k_lz" in cache:
            khat = dlzs.lz_unpack(
                cache["k_lz"][torch.clamp(past_phys, min=0).long()], q.dtype)
            khat = khat.reshape(1, sp, cfg.n_kv, cfg.head_dim)
        else:
            khat = dlzs.pow2_quantize(kg)
        s_hat = torch.einsum("btgrd,bsgd->bgrts", qg, khat).float() * scale
        s_hat = s_hat.masked_fill(~mask[..., :sp], NEG_INF)
        page_max = s_hat.reshape(b, cfg.n_kv, n_rep, t, wp, page
                                 ).amax(dim=(0, 1, 2, 3, 5))     # [Wp]
        lanes = torch.arange(s_lanes, device=x.device)
        lane_max = torch.where(past_lane[:, None] == lanes[None, :],
                               page_max[:, None],
                               torch.full_like(page_max[:, None], NEG_INF)
                               ).amax(dim=0)                     # [S]
        keep = page_max >= \
            lane_max[torch.clamp(past_lane, min=0).long()] - cfg.star.radius
        keep_rows = keep[:, None].expand(wp, page).reshape(sp)
        keep_all = torch.cat([keep_rows, torch.ones(
            (t,), dtype=torch.bool, device=x.device)])
        mask = mask & keep_all[None, None, None, None, :]

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
