"""Adafactor (Shazeer & Stern, 2018; ``repro.optim.adafactor``): a
factored second moment, no momentum.

The state of an [*, a, b] weight is a row vector [*, a] and a column
vector [*, b] instead of a full second moment. The math is the
reference's, in fp32, written back in place. Where the reference updates
a large layer-stacked factored leaf one layer at a time (more than 2^24
elements, three or more dims), its update-RMS clipping is taken per
layer; the port takes the same slices, so the two compute one function.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.adamw import global_norm
from repro_torch.tree import sorted_items


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8            # beta2 annealed: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0   # update RMS clipping
    weight_decay: float = 0.0
    min_dim_factored: int = 128   # don't factor tiny trailing dims


def _factored(p, cfg: AdafactorConfig) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= cfg.min_dim_factored
            and p.shape[-2] >= cfg.min_dim_factored)


def adafactor_init(params, cfg: AdafactorConfig) -> dict:
    def leaf(p):
        if isinstance(p, dict):
            return {k: leaf(v) for k, v in p.items()}
        if _factored(p, cfg):
            return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                     dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}
    device = next(leaf for _, leaf in sorted_items(params)).device
    return {"slots": leaf(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _update(slot: dict, p, g, beta2, lr, cfg: AdafactorConfig) -> None:
    """One leaf (or one layer of it), in place."""
    g32 = g.float()
    sq = g32.square() + cfg.eps
    if "r" in slot:
        r = beta2 * slot["r"] + (1 - beta2) * sq.mean(dim=-1)
        c = beta2 * slot["c"] + (1 - beta2) * sq.mean(dim=-2)
        # vhat ≈ r cᵀ / mean(r)
        denom = torch.clamp(r.mean(dim=-1, keepdim=True), min=cfg.eps)
        vhat = (r / denom)[..., None] * c[..., None, :]
        slot["r"].copy_(r)
        slot["c"].copy_(c)
    else:
        vhat = beta2 * slot["v"] + (1 - beta2) * sq
        slot["v"].copy_(vhat)
    u = g32 * torch.rsqrt(vhat + cfg.eps)
    rms = torch.sqrt(u.square().mean() + 1e-30)     # update RMS clipping
    u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
    p32 = p.float()
    p.copy_(p32 - lr * (u + cfg.weight_decay * p32))


def adafactor_update(params, grads, state, cfg: AdafactorConfig,
                     lr_scale=1.0):
    """One Adafactor step. Returns (params, state, gn): the same trees,
    updated in place; ``gn`` is the gradients' global norm (reported,
    not clipped to)."""
    step = state["step"] + 1
    gn = global_norm(grads)
    beta2 = 1.0 - step.to(torch.float32) ** (-cfg.decay)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)
    slots = dict(_slot_items(state["slots"]))
    g_items = dict(sorted_items(grads))
    with torch.no_grad():
        for path, p in sorted_items(params):
            slot, g = slots[path], g_items[path]
            if p.numel() > (1 << 24) and p.dim() >= 3 and p.shape[0] > 1 \
                    and "r" in slot:
                for i in range(p.shape[0]):     # the reference's slices
                    _update({"r": slot["r"][i], "c": slot["c"][i]}, p[i],
                            g[i], beta2, lr, cfg)
            else:
                _update(slot, p, g, beta2, lr, cfg)
    state["step"] = step
    return params, state, gn


def _slot_items(tree, path: tuple = ()):
    """(param path, slot dict) for every leaf's slot."""
    if "r" in tree or "v" in tree:
        yield path, tree
        return
    for k in sorted(tree):
        yield from _slot_items(tree[k], path + (k,))
