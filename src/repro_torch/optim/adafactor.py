"""Adafactor (Shazeer & Stern, 2018; ``repro.optim.adafactor``): a
factored second moment, no momentum.

The state of an [*, a, b] weight is a row vector [*, a] and a column
vector [*, b] instead of a full second moment. The math is the
reference's, in fp32, written back in place. Where the reference updates
a large layer-stacked factored leaf one layer at a time (more than 2^24
elements, three or more dims), its update-RMS clipping is taken per
layer; the port takes the same slices, so the two compute one function.
A factored slice (or a leaf the reference updates whole) above
``ROW_BLOCK_ELEMENTS`` (2^29) is updated a block of rows of one [a, b]
block at a time, in three passes: the factors (row means, column sums),
then the update's sum of squares, then the update, so that one row
block's fp32 temporaries (at most 2 GB each) are live at a time instead
of the slice's: Grok-1's [16, 6144, 16384] experts of a layer (about 6.4
GB each), Nemotron-4-340B's [256000, 18432] embedding (18.9 GB each).
This form reads the gradient three times and takes about a third longer
than the whole slice's on an H100, so a slice at or under the threshold
(Jamba-1.5-Large's [65536, 8192] embedding) keeps the reference's form.
Its column means and sum of squares are summed in another order than the
reference's.
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


SLICE_ELEMENTS = 1 << 24     # the reference's threshold for sliced leaves
ROW_BLOCK_ELEMENTS = 1 << 29  # the most elements updated at once


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


def _vhat(slot: dict, g32, beta2, cfg: AdafactorConfig):
    """The second-moment estimate of ``g32`` after this step, its state
    written into ``slot``."""
    sq = g32.square() + cfg.eps
    if "r" in slot:
        r = beta2 * slot["r"] + (1 - beta2) * sq.mean(dim=-1)
        c = beta2 * slot["c"] + (1 - beta2) * sq.mean(dim=-2)
        slot["r"].copy_(r)
        slot["c"].copy_(c)
        return _factored_vhat(r, c, cfg)
    vhat = beta2 * slot["v"] + (1 - beta2) * sq
    slot["v"].copy_(vhat)
    return vhat


def _factored_vhat(r, c, cfg: AdafactorConfig):
    # vhat ≈ r cᵀ / mean(r)
    denom = torch.clamp(r.mean(dim=-1, keepdim=True), min=cfg.eps)
    return (r / denom)[..., None] * c[..., None, :]


def _apply(p, u, lr, cfg: AdafactorConfig) -> None:
    p32 = p.float()
    p.copy_(p32 - lr * (u + cfg.weight_decay * p32))


def _update(slot: dict, p, g, beta2, lr, cfg: AdafactorConfig) -> None:
    """One leaf (or one layer of it), in place."""
    g32 = g.float()
    u = g32 * torch.rsqrt(_vhat(slot, g32, beta2, cfg) + cfg.eps)
    rms = torch.sqrt(u.square().mean() + 1e-30)     # update RMS clipping
    _apply(p, u / torch.clamp(rms / cfg.clip_threshold, min=1.0), lr, cfg)


def _update_blocked(slot: dict, p, g, beta2, lr, cfg: AdafactorConfig
                    ) -> None:
    """``_update`` of a factored leaf [..., a, b] (its factors per [a, b]
    block) in blocks of at most ``ROW_BLOCK_ELEMENTS`` elements of one
    block's rows: first each block's factors, from its row blocks' row
    means and column sums; then the update's sum of squares; then each
    row block's update, recomputed from the new factors, under the whole
    leaf's RMS clipping."""
    a, b = p.shape[-2:]
    ps, gs = p.view(-1, a, b), g.reshape(-1, a, b)
    rs, cs = slot["r"].view(-1, a), slot["c"].view(-1, b)
    step = max(1, ROW_BLOCK_ELEMENTS // b)
    parts = [(n, slice(i, i + step)) for n in range(ps.shape[0])
             for i in range(0, a, step)]
    cols = torch.zeros(cs.shape, dtype=torch.float32, device=p.device)
    for n, rows in parts:
        sq = gs[n, rows].float().square() + cfg.eps
        rs[n, rows].copy_(beta2 * rs[n, rows] + (1 - beta2) * sq.mean(dim=-1))
        cols[n] += sq.sum(dim=0)
    cs.copy_(beta2 * cs + (1 - beta2) * (cols / a))
    denom = torch.clamp(rs.mean(dim=-1), min=cfg.eps)

    def update(n, rows):
        vhat = (rs[n, rows] / denom[n])[:, None] * cs[n][None, :]
        return gs[n, rows].float() * torch.rsqrt(vhat + cfg.eps)
    total = torch.zeros((), dtype=torch.float32, device=p.device)
    for n, rows in parts:
        total = total + update(n, rows).square().sum()
    clip = torch.clamp(torch.sqrt(total / p.numel() + 1e-30)
                       / cfg.clip_threshold, min=1.0)
    for n, rows in parts:
        _apply(ps[n, rows], update(n, rows) / clip, lr, cfg)


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
            factored = "r" in slot
            pieces = [({"r": slot["r"][i], "c": slot["c"][i]}, p[i], g[i])
                      for i in range(p.shape[0])] \
                if factored and p.numel() > SLICE_ELEMENTS and p.dim() >= 3 \
                else [(slot, p, g)]             # the reference's slices
            for sl, pp, gg in pieces:
                blocked = factored and pp.numel() > ROW_BLOCK_ELEMENTS
                (_update_blocked if blocked else _update)(
                    sl, pp, gg, beta2, lr, cfg)
    state["step"] = step
    return params, state, gn


def _slot_items(tree, path: tuple = ()):
    """(param path, slot dict) for every leaf's slot."""
    if "r" in tree or "v" in tree:
        yield path, tree
        return
    for k in sorted(tree):
        yield from _slot_items(tree[k], path + (k,))
