"""Public entry points of the prefill tile kernels and the fused STAR
prefill, port of ``repro.kernels.ops``.

``star_attention_fused`` chains the three stages:
  K2 ``dlzs_block_scores`` (predicted tile maxima; Â stays on chip)
  -> SADS tile top-k over the [BH, n_qt, n_kt] maxima (descending, ties to
     the lower index) and the sphere validity test
  -> K3 ``sufa_attention``, which reads the selected K/V tiles in place
     from the tile ids and builds the validity and causal mask itself (the
     TPU pipeline gathers the tiles and their mask between the two
     kernels; here only K3's plain version does).
``star_attention_cfg`` runs it under a ``STARConfig`` so that it computes
what ``core.star_attention.star_attention_scanq`` computes, the
element-level sphere mask of ``elementwise=True`` included (K3 applies
it); the model's STAR prefill calls it, and its dense prefill calls
``flash`` (K4).

Every call goes through the wrappers, so on the CPU the plain versions
run and on a GPU the kernels launch.

Tile ties. The plain STAR form computes Â in the model dtype,
``bf16(bf16(Q·pow2(K)ᵀ)·scale)`` when q is bf16, so its tile maxima tie
often and the top-k breaks ties toward the lower index. K2 returns fp32
maxima, as the TPU kernel does. The glue asks K2 for unscaled maxima and
rounds them exactly as Â is rounded: rounding and a positive scale are
monotone, so the rounded maximum is the maximum of the rounded scores,
and the selection (ties included) is the plain form's. In fp32 the
rounding is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.sads import top_k_lower_index_ties
from repro_torch.core.star_attention import STARConfig
from repro_torch.kernels.dlzs import dlzs_block_scores
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.sufa import sufa_attention


def flash(q, k, v, *, causal=True, scale=None):
    return flash_attention(q, k, v, causal=causal, scale=scale)


def sufa(q, k, v, idx, valid, *, block_q=128, block_kv=128, causal=True,
         strict=False, scale=None):
    return sufa_attention(q, k, v, idx, valid, block_q=block_q,
                          block_kv=block_kv, causal=causal, scale=scale,
                          strict=strict)


def dlzs_blockmax(q, k, *, causal=True, block_q=128, block_kv=128,
                  scale=None):
    return dlzs_block_scores(q, k, causal=causal, scale=scale,
                             block_q=block_q, block_kv=block_kv)


def select_tiles(raw: torch.Tensor, keep: int, *, scale: float,
                 radius: float, dtype: torch.dtype):
    """SADS over K2's unscaled fp32 maxima ``raw`` [BH, n_qt, n_kt]:
    rounds them as the plain form rounds Â (see the module docstring),
    keeps the top ``keep`` per query tile and tests the sphere.
    Returns (tile ids [BH, n_qt, keep], valid [BH, n_qt, keep])."""
    est = (raw.to(dtype) * scale).masked_fill(raw <= NEG_INF / 2, NEG_INF)
    vals, idx = top_k_lower_index_ties(est, keep)
    valid = (vals > NEG_INF / 2) & (vals >= vals[..., :1] - radius)
    return idx, valid


def star_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, keep: int, causal: bool = True,
                         block_q: int = 128, block_kv: int = 128,
                         radius: float = 5.0, strict: bool = False,
                         elementwise: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The kernel-side STAR pipeline. q [BH, T, d], k/v [BH, S, d]
    -> [BH, T, d]; the queries are the last T of the S positions.
    ``elementwise`` adds the element-level sphere inside the kept tiles."""
    bh, t, d = q.shape
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    block_q = min(block_q, t)
    block_kv = min(block_kv, s)
    if t % block_q or s % block_kv:
        raise ValueError(f"STAR prefill: T={t}, S={s} must be multiples of "
                         f"the tiles {block_q} x {block_kv}")
    keep = min(keep, s // block_kv)

    # Stage 1+2a (K2): unscaled predicted tile maxima.
    raw = dlzs_block_scores(q, k, causal=causal, scale=1.0, block_q=block_q,
                            block_kv=block_kv)
    # Stage 2b: SADS tile top-k (descending) + sphere on the tiny matrix.
    idx, valid = select_tiles(raw, keep, scale=scale, radius=radius,
                              dtype=q.dtype)
    # Stage 3 (K3): block-sparse flash over the survivors, read in place.
    return sufa_attention(q, k, v, idx, valid, block_q=block_q,
                          block_kv=block_kv, causal=causal, scale=scale,
                          strict=strict, elementwise=elementwise,
                          radius=radius)


def star_attention_cfg(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: STARConfig, *, causal: bool,
                       scale: Optional[float] = None) -> torch.Tensor:
    """What ``core.star_attention.star_attention_scanq`` computes, through
    the fused pipeline. q [BH, T, d], k/v [BH, S, d] -> [BH, T, d].

    The q-chunking of ``scanq`` changes no query tile's selection, so one
    fused call covers the whole T. With ``prefix_groups`` G > 1 (causal,
    T == S, T longer than one chunk) group g's queries run over the
    visible prefix ``k[:(g+1)·S/G]`` alone, with ``keep`` recomputed for
    that prefix, as ``scanq`` does. With ``elementwise`` each query row
    also drops the keys of its kept tiles whose estimate lies more than
    ``radius`` below its best (K3's element mask; its plain version on the
    CPU)."""
    bh, t, _ = q.shape
    s = k.shape[1]
    # the model's gathered SU-FA is the strict recurrence
    strict = cfg.strict if cfg.use_scan else True
    chunk = min(cfg.block_q, t) * cfg.chunk_tiles
    groups = 1
    if t > chunk:
        if t % chunk:
            raise ValueError(f"T={t} not divisible by q-chunk {chunk}")
        n_chunks = t // chunk
        groups = cfg.prefix_groups if (causal and t == s) else 1
        while n_chunks % groups or s % groups:
            groups -= 1
    rows = t // groups
    outs = []
    for g in range(groups):
        prefix = s if groups == 1 else (g + 1) * (s // groups)
        qg = q[:, g * rows:(g + 1) * rows].contiguous()
        kp = k[:, :prefix].contiguous()
        vp = v[:, :prefix].contiguous()
        tiles = dataclasses.replace(cfg, block_q=min(cfg.block_q, rows),
                                    block_kv=min(cfg.block_kv, prefix))
        outs.append(star_attention_fused(
            qg, kp, vp, keep=tiles.keep_blocks(prefix), causal=causal,
            block_q=tiles.block_q, block_kv=tiles.block_kv,
            radius=cfg.radius, strict=strict, elementwise=cfg.elementwise,
            scale=scale))
    return outs[0] if groups == 1 else torch.cat(outs, dim=1)
