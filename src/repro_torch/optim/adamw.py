"""AdamW (``repro.optim.adamw``): fp32 math, moments in ``moment_dtype``
(bf16 halves optimizer memory), global-norm clipping.

The reference updates very large leaves a block of rows at a time inside
a ``fori_loop``, an XLA memory device; the port updates one leaf at a
time in fp32 and writes the parameter and its moments back IN PLACE (no
second copy of the parameters), which at 1.3 B parameters fits one
80 GB card.
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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, summed over the
    leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    total = None
    for _, leaf in sorted_items(tree):
        sq = leaf.float().square().sum()
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
    with torch.no_grad():
        for path, p in sorted_items(params):
            g32 = g_items[path].float() * clip
            m, v = m_items[path], v_items[path]
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
    state["step"] = step
    return params, state, gn
