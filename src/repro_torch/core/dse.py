"""Design-space exploration for the SADS sub-segment size (paper
Appendix A); the port's copy of ``repro.core.dse``.

The segment granularity S_i trades sorting complexity against SU-FA
overhead: smaller segments cut comparisons (O(S·S·k·rho/n)) but fragment
the formal stage (more tiles -> more per-tile bookkeeping and sync);
larger segments do the opposite. The paper's DSE minimizes
J = alpha·C_sort + beta·C_exp with per-model alpha/beta (e.g. 0.24/0.31
for BERT, 0.58/0.63 for LLaMA), over the equivalent-add op model.

The candidates are the reference's, which it ties to the TPU's 128-lane
tile. On the card K2 and K3 take tiles that are multiples of 16 up to 128
(``kernels.launch.check_tile``): the ``wgmma`` + TMA form at 128 x 128,
``mma.sync`` at the others (``kernels.launch.tile_form``). So of these
candidates only 128 is one kernel tile; the larger ones stay in the
sweep as the paper's segment sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import opcount

# Paper §VI-B per-model DSE coefficients (alpha: sort weight, beta: exp weight).
PAPER_COEFFS = {
    "bert": (0.24, 0.31),
    "vit": (0.2, 0.24),
    "gpt2": (0.4, 0.42),
    "bloom": (0.53, 0.56),
    "llama": (0.58, 0.63),
}


@dataclasses.dataclass(frozen=True)
class DSEResult:
    block_kv: int          # chosen segment size (= kernel KV tile)
    n_segments: int
    objective: float
    table: tuple           # ((block_kv, J), ...) full sweep for reporting


def segment_dse(seq_len: int, *, t: int = 128, d: int = 128,
                k_ratio: float = 0.2, rho: float = 0.4,
                alpha: float = 0.5, beta: float = 0.5,
                candidates: Sequence[int] = (128, 256, 512, 1024, 2048),
                strict: bool = False) -> DSEResult:
    """Minimize J(n) = alpha·sort_cost + beta·formal_cost over segment sizes."""
    rows = []
    for bc in candidates:
        if seq_len % bc or seq_len // bc < 1:
            continue
        n = seq_len // bc
        if (seq_len * k_ratio) < n:  # need >= 1 kept element per segment
            continue
        sort_cost = opcount.sads_ops(t, seq_len, k_ratio, n, rho).equivalent_adds
        formal = opcount.sufa_ops(t, seq_len, d, bc, k_ratio, strict)
        # beta weights the non-matmul (exp-dominated) overhead specifically.
        exp_cost = opcount.OpCount(exp=formal.exp, cmp=formal.cmp,
                                   mul=formal.mul).equivalent_adds
        j = alpha * sort_cost + beta * exp_cost
        rows.append((bc, j))
    if not rows:
        raise ValueError(f"no feasible segment size for S={seq_len}")
    best = min(rows, key=lambda r: r[1])
    return DSEResult(block_kv=best[0], n_segments=seq_len // best[0],
                     objective=best[1], table=tuple(rows))


def dse_for_model(model: str, seq_len: int, **kw) -> DSEResult:
    alpha, beta = PAPER_COEFFS.get(model, (0.5, 0.5))
    return segment_dse(seq_len, alpha=alpha, beta=beta, **kw)
