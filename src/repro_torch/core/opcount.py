"""Equivalent-addition complexity model (paper footnote 1 + Figs. 5/16/18):
the port's own copy of ``repro.core.opcount`` (pure arithmetic, the same
values).

C = α·N_add + β·N_mul + γ·N_cmp + δ·N_div + ε·N_exp with
α=1, β=3, γ=1, δ=8, ε=25 (Brent & Zimmermann [15]). Every benchmark that
reproduces a paper complexity figure goes through this module so the weights
live in exactly one place.
"""

from __future__ import annotations

import dataclasses

ALPHA, BETA, GAMMA, DELTA, EPSILON = 1.0, 3.0, 1.0, 8.0, 25.0


@dataclasses.dataclass(frozen=True)
class OpCount:
    add: float = 0.0
    mul: float = 0.0
    cmp: float = 0.0
    div: float = 0.0
    exp: float = 0.0

    def __add__(self, other: "OpCount") -> "OpCount":
        return OpCount(*(getattr(self, f.name) + getattr(other, f.name)
                         for f in dataclasses.fields(self)))

    def scaled(self, c: float) -> "OpCount":
        return OpCount(*(c * getattr(self, f.name)
                         for f in dataclasses.fields(self)))

    @property
    def equivalent_adds(self) -> float:
        return (ALPHA * self.add + BETA * self.mul + GAMMA * self.cmp
                + DELTA * self.div + EPSILON * self.exp)


def matmul_ops(m: int, n: int, k: int) -> OpCount:
    """[m,k] @ [k,n]."""
    return OpCount(mul=m * n * k, add=m * n * (k - 1))


def shift_matmul_ops(m: int, n: int, k: int) -> OpCount:
    """DLZS 'matmul': shifts are free in the ASIC model — adds only."""
    return OpCount(add=m * n * k)


def vanilla_attention_ops(t: int, s: int, d: int) -> OpCount:
    """Dense attention, monolithic softmax (no tiling): QKᵀ, softmax, AV."""
    ops = matmul_ops(t, s, d)                       # QK^T
    ops += OpCount(cmp=t * (s - 1))                 # rowmax
    ops += OpCount(add=t * s, exp=t * s)            # subtract max, exp
    ops += OpCount(add=t * (s - 1), div=t * s)      # rowsum, normalize
    ops += matmul_ops(t, d, s)                      # A·V
    return ops


def fa2_ops(t: int, s: int, d: int, block_kv: int) -> OpCount:
    """FlashAttention-2 (Fig. 5a): per KV tile — rowmax over Bc, max-merge,
    exp(Bc) + correction exp, l rescale (1 mul), o rescale (d mul)."""
    n_tiles = s // block_kv
    ops = matmul_ops(t, s, d) + matmul_ops(t, d, s)  # same matmul work
    per_tile_row = OpCount(
        cmp=(block_kv - 1) + 1,       # rowmax(S_ij) + m' = max(m, ·)
        exp=block_kv + 1,             # exp(S_ij - m') + correction e^{m-m'}
        add=block_kv + (block_kv - 1) + 1,  # subtract m', rowsum, l merge
        mul=1 + d,                    # l rescale + o rescale
    )
    ops += per_tile_row.scaled(t * n_tiles)
    ops += OpCount(div=t * d)         # final o / l
    return ops


def sufa_ops(t: int, s: int, d: int, block_kv: int, keep_ratio: float,
             strict: bool = False) -> OpCount:
    """SU-FA over the selected tiles only (keep_ratio of tiles survive SADS).

    Descend updating (strict=False): no max comparisons against the running
    max and no o/l rescale multiplies after tile 0 (Fig. 11b).
    """
    n_tiles = max(1, round((s // block_kv) * keep_ratio))
    s_eff = n_tiles * block_kv
    ops = matmul_ops(t, s_eff, d) + matmul_ops(t, d, s_eff)
    per_tile_row = OpCount(
        cmp=(block_kv - 1) + (1 if strict else 0),
        exp=block_kv + (1 if strict else 0),
        add=block_kv + (block_kv - 1) + 1,
        mul=(1 + d) if strict else 0,
    )
    ops += per_tile_row.scaled(t * n_tiles)
    ops += OpCount(div=t * d)
    return ops


def full_sort_topk_ops(t: int, s: int, k_ratio: float) -> OpCount:
    """Row-wide selection of S·k entries, O(S) per selected entry (paper §III)."""
    k = s * k_ratio
    return OpCount(cmp=t * s * k)


def sads_ops(t: int, s: int, k_ratio: float, n_segments: int,
             rho: float) -> OpCount:
    """SADS: per segment, find max (S/n cmp), sphere filter (S/n cmp), then
    top-(k/n) over the surviving rho fraction: O((S/n)·rho·(k/n)) per segment.
    Total O(S·S·k·rho/n) per row (paper's complexity claim)."""
    seg = s // n_segments
    k_seg = (s * k_ratio) / n_segments
    per_seg = OpCount(cmp=(seg - 1) + seg + seg * rho * k_seg)
    return per_seg.scaled(t * n_segments)


def dense_predict_ops(t: int, s: int, d: int) -> OpCount:
    """Baseline prediction: low-bit (4-bit MSB) multiply Q·Kᵀ — still mults."""
    return matmul_ops(t, s, d)


def dlzs_predict_ops(t: int, s: int, d: int) -> OpCount:
    """DLZS prediction: shift-only log-domain matmul (adds only)."""
    return shift_matmul_ops(t, s, d)


def dlzs_khat_ops(s: int, h: int, d: int) -> OpCount:
    """Cross-phase Key prediction K̂ = X · pow2(W_k): shift-only as well."""
    return shift_matmul_ops(s, d, h)


def star_total_ops(t: int, s: int, d: int, *, block_kv: int, k_ratio: float,
                   n_segments: int, rho: float, strict: bool = False,
                   ) -> OpCount:
    """Full STAR flow: DLZS predict + SADS select + SU-FA formal compute."""
    keep_ratio = k_ratio  # tile-level keep tracks the element top-k ratio
    return (dlzs_predict_ops(t, s, d)
            + sads_ops(t, s, k_ratio, n_segments, rho)
            + sufa_ops(t, s, d, block_kv, keep_ratio, strict))


def baseline_ds_ops(t: int, s: int, d: int, *, block_kv: int,
                    k_ratio: float) -> OpCount:
    """The ablation baseline (paper §VI-B): 4-bit multiply prediction +
    vanilla full sort + traditional FA on the kept tokens."""
    return (dense_predict_ops(t, s, d)
            + full_sort_topk_ops(t, s, k_ratio)
            + fa2_ops(t, max(block_kv, int(s * k_ratio)), d, block_kv))
