"""The STAR cross-stage pipeline: DLZS predict -> SADS select -> SU-FA
compute. PyTorch port of ``repro.core.star_attention``.

These run in plain PyTorch, as the JAX reference hands them to XLA. The
model's STAR prefill does not call the prefill forms: it runs the fused
tile kernels (K2 DLZS block maxima -> SADS -> K3 SU-FA) through
``kernels.ops.star_attention_cfg``, which computes what
``star_attention_scanq`` computes. These stay as the plain form the tests
and the on-card smoke hold that path against. ``star_decode`` is the dense
slot engine's sparse decode (``models.attention.apply_decode``).

Entry points:
  * ``star_attention``       — tile-granular prefill attention (one head).
  * ``star_attention_scanq`` — the same over query chunks, memory O(chunk),
                               with causal ``prefix_groups``.
  * ``star_decode``          — element-granular decode against a dense
                               (optionally LZ-compressed) KV cache.
  * ``dense_attention``      — the non-sparse baseline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import dlzs, sads, sufa
from repro_torch.core.sads import NEG_INF


@dataclasses.dataclass(frozen=True)
class STARConfig:
    """Static configuration of the STAR sparse-attention pipeline."""

    top_k_ratio: float = 0.2     # fraction of KV kept (paper sweet spot .15-.2)
    block_q: int = 128           # B_r — query tile rows
    block_kv: int = 128          # B_c — KV tile cols = SADS segment size
    radius: float = 5.0          # sphere radius r (paper default)
    strict: bool = True          # exact rescale vs descend-updating fast path
    elementwise: bool = False    # apply in-tile sphere masks (element SADS)
    use_scan: bool = False       # streaming SU-FA (faithful) vs gathered
    chunk_tiles: int = 4         # q tiles per scan step (scanq path)
    prefix_groups: int = 1       # causal prefill: split Q into G groups that
    #                              predict only over their visible K prefix

    def keep_blocks(self, s: int) -> int:
        n_kt = s // self.block_kv
        return max(1, min(n_kt, math.ceil(self.top_k_ratio * n_kt)))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Dense softmax attention (single head): the paper's dense baseline."""
    t, d = q.shape[-2], q.shape[-1]
    s = k.shape[-2]
    scale = scale or (1.0 / math.sqrt(d))
    sc = torch.einsum("...td,...sd->...ts", q, k).float() * scale
    if causal:
        offset = s - t  # queries are the last t positions
        mask = (torch.arange(s, device=q.device)[None, :]
                <= (torch.arange(t, device=q.device)[:, None] + offset))
        sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p.masked_fill(sc <= NEG_INF / 2, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("...ts,...sd->...td", p / l, v.float())
    return out.to(q.dtype)


def predict_scores(q: torch.Tensor, k: torch.Tensor, *, scale: float,
                   k_lz: Optional[torch.Tensor] = None,
                   k_pow2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage 1: DLZS estimated scores Â. Precedence: an int8 LZ cache
    ``k_lz`` > a precomputed ``k_pow2`` > on-the-fly pow2 of K."""
    if k_lz is not None:
        k_pow2 = dlzs.lz_unpack(k_lz, q.dtype)
    elif k_pow2 is None:
        k_pow2 = dlzs.pow2_quantize(k)
    return dlzs.dlzs_scores(q, k_pow2, scale)


def star_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: STARConfig, *, causal: bool,
                   q_offset: Optional[int] = None,
                   k_lz: Optional[torch.Tensor] = None,
                   k_pow2: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full STAR pipeline for one head. q [T,d], k/v [S,d] -> [T,d].

    ``q_offset`` is the absolute position of q row 0 (default: queries are
    the trailing T positions of the S keys).
    """
    t, d = q.shape
    s = k.shape[0]
    scale = scale or (1.0 / math.sqrt(d))
    if cfg.block_q > t or cfg.block_kv > s:
        cfg = dataclasses.replace(cfg, block_q=min(cfg.block_q, t),
                                  block_kv=min(cfg.block_kv, s))
    if q_offset is None:
        q_offset = s - t
    dev = q.device
    q_pos = torch.arange(t, device=dev) + q_offset          # [T]
    kv_pos_all = torch.arange(s, device=dev)                # [S]

    # Stage 1 — DLZS prediction (log-domain, one-sided quantization).
    s_hat = predict_scores(q, k, scale=scale, k_lz=k_lz, k_pow2=k_pow2)
    if causal:
        s_hat = s_hat.masked_fill(kv_pos_all[None, :] > q_pos[:, None],
                                  NEG_INF)

    # Stage 2 — SADS tile selection (top-k per q-tile, desc by max).
    sel = sads.sads_select_blocks(
        s_hat, cfg.block_q, cfg.block_kv, cfg.keep_blocks(s),
        radius=cfg.radius, causal=False)  # causality already folded in

    n_qt = t // cfg.block_q
    elem_mask = None
    if causal:
        # In-tile causal masking (diagonal tiles are partially visible).
        qp = q_pos.reshape(n_qt, cfg.block_q)
        kv_pos = (sel.block_idx[..., None] * cfg.block_kv
                  + torch.arange(cfg.block_kv, device=dev))  # [n_qt,keep,Bc]
        elem_mask = kv_pos[:, :, None, :] <= qp[:, None, :, None]
    if cfg.elementwise:
        # Element-level sphere pruning inside the selected tiles.
        sh = s_hat.reshape(n_qt, cfg.block_q, s // cfg.block_kv,
                           cfg.block_kv)
        idx = sel.block_idx[:, None, :, None].expand(
            n_qt, cfg.block_q, sel.block_idx.shape[-1], cfg.block_kv)
        sh_sel = torch.gather(sh, 2, idx)                   # [n_qt,Bq,keep,Bc]
        row_max = sh_sel.masked_fill(
            ~sel.block_valid[:, None, :, None], NEG_INF
        ).amax(dim=(2, 3), keepdim=True)
        sphere = (sh_sel >= (row_max - cfg.radius)).transpose(1, 2)
        elem_mask = sphere if elem_mask is None else (elem_mask & sphere)

    # Stage 3 — SU-FA formal compute on the survivors.
    if cfg.use_scan:
        return sufa.sufa_scan(
            q, k, v, sel, scale=scale, block_q=cfg.block_q,
            block_kv=cfg.block_kv, strict=cfg.strict, elem_mask=elem_mask)
    return sufa.sufa_gathered(
        q, k, v, sel, scale=scale, block_q=cfg.block_q,
        block_kv=cfg.block_kv, elem_mask=elem_mask)


def star_attention_scanq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cfg: STARConfig, *, causal: bool,
                         q_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """STAR attention over query chunks (memory O(chunk), long T).

    The pow2-quantized K is computed once and reused by every chunk — the
    cross-phase reuse from the paper. With ``prefix_groups`` G > 1 (causal
    self-attention only), group g's queries predict and gather over the
    visible prefix ``k[:(g+1)·S/G]`` alone.
    """
    t, d = q.shape
    s = k.shape[0]
    chunk = min(cfg.block_q, t) * cfg.chunk_tiles
    if t <= chunk:
        return star_attention(q, k, v, cfg, causal=causal, q_offset=q_offset,
                              scale=scale)
    if t % chunk:
        raise ValueError(f"T={t} not divisible by q-chunk {chunk}")
    n_chunks = t // chunk
    k_pow2 = dlzs.pow2_quantize(k)

    groups = cfg.prefix_groups if (causal and t == s and q_offset == 0) else 1
    while n_chunks % groups or s % groups:
        groups -= 1
    cpg = n_chunks // groups
    outs = []
    for g in range(groups):
        prefix = s if groups == 1 else (g + 1) * (s // groups)
        for c in range(g * cpg, (g + 1) * cpg):
            outs.append(star_attention(
                q[c * chunk:(c + 1) * chunk], k[:prefix], v[:prefix], cfg,
                causal=causal, q_offset=q_offset + c * chunk,
                k_pow2=k_pow2[:prefix], scale=scale))
    return torch.cat(outs, dim=0)


def star_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: STARConfig, *, length: torch.Tensor,
                k_lz: Optional[torch.Tensor] = None,
                n_segments: Optional[int] = None,
                scale: Optional[float] = None) -> torch.Tensor:
    """Element-granular STAR decode: one query per head against a KV cache.

    q [..., d]; k/v [..., S_max, d] and ``k_lz`` (int8 LZ codes of k) with
    leading dims that broadcast against q's (the reference vmaps one head
    at a time; here the heads are a batch, so a GQA group's queries share
    their cache rows); ``length`` [...] (broadcast likewise) marks each
    row's valid prefix. Prediction reads the LZ codes when given; the
    formal stage gathers only the selected rows."""
    s, d = k.shape[-2], k.shape[-1]
    scale = scale or (1.0 / math.sqrt(d))
    n_seg = n_segments or max(1, s // cfg.block_kv)
    s_hat = predict_scores(q[..., None, :], k, scale=scale,
                           k_lz=k_lz)[..., 0, :]             # [..., S]
    valid = torch.arange(s, device=q.device) < length[..., None]
    s_hat = s_hat.masked_fill(~valid, NEG_INF)

    k_total = max(n_seg, int(s * cfg.top_k_ratio) // n_seg * n_seg)
    sel = sads.sads_select(s_hat, k_total, n_seg, cfg.radius)
    kg = sads.gather_selected(k, sel.indices)                # [..., k, d]
    vg = sads.gather_selected(v, sel.indices)
    sc = (kg @ q[..., None])[..., 0].float() * scale        # exact, k only
    sc = sc.masked_fill(~sel.valid, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m).masked_fill(sc <= NEG_INF / 2, 0.0)
    out = (p[..., None, :] @ vg.float())[..., 0, :] / torch.clamp(
        p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)
