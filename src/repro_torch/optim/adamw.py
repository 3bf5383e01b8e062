"""AdamW (``repro.optim.adamw``): fp32 math, moments in ``moment_dtype``
(bf16 halves optimizer memory), global-norm clipping.

The port updates one leaf at a time in fp32 and writes the parameter and
its moments back IN PLACE (no second copy of the parameters). A leaf of
more than ``SLICE_ELEMENTS`` elements is updated, and its square summed
for the global norm, a block of leading rows at a time, in the
reference's block counts: its whole-leaf form keeps about six fp32
copies alive (8.6 GB each for OLMoE-1B-7B's [16, 64, 2048, 1024] expert
leaf). The update is elementwise, so the blocks give the whole leaf's
bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import sorted_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32   # bf16 halves optimizer memory


SLICE_ELEMENTS = 1 << 27     # the reference's threshold for blocked leaves


def _divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (1 if n is prime > cap)."""
    best = 1
    for d in range(1, cap + 1):
        if n % d == 0:
            best = d
    return best


def row_blocks(x: torch.Tensor, cap: int) -> int:
    """The number of blocks of leading rows a leaf is taken in: the
    largest divisor of ``shape[0]`` up to ``cap`` where the leaf has more
    than ``SLICE_ELEMENTS`` elements and two or more dims, else 1 (the
    reference's ``_sqsum`` with cap 32, its ``adamw_update`` with 64)."""
    n_blk = _divisor_leq(x.shape[0], cap) if x.dim() >= 2 else 1
    return n_blk if x.numel() > SLICE_ELEMENTS else 1


def _sqsum(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of ``x``, a block of leading rows at a time
    where ``row_blocks(x, 32) > 1`` (no whole-leaf fp32 copy)."""
    n_blk = row_blocks(x, 32)
    if n_blk == 1:
        return x.float().square().sum()
    rows = x.shape[0] // n_blk
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_blk):
        acc = acc + x[i * rows:(i + 1) * rows].float().square().sum()
    return acc


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, summed over the
    leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    total = None
    for _, leaf in sorted_items(tree):
        sq = _sqsum(leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = next(leaf for _, leaf in sorted_items(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step with global-norm clipping. Returns (params, state,
    gn): the same trees, updated in place. All math in fp32; the
    parameters and moments are cast back to their storage dtypes."""
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)
    m_items = dict(sorted_items(state["m"]))
    v_items = dict(sorted_items(state["v"]))
    g_items = dict(sorted_items(grads))

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    with torch.no_grad():
        for path, p in sorted_items(params):
            leaf = (p, g_items[path], m_items[path], v_items[path])
            n_blk = row_blocks(p, 64)
            rows = p.shape[0] // n_blk
            for i in range(n_blk):
                upd(*(t[i * rows:(i + 1) * rows] if n_blk > 1 else t
                      for t in leaf))
    state["step"] = step
    return params, state, gn
