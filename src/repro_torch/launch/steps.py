"""Step factories of the launch layer (``repro.launch.steps``): the
optimizer for an arch, the training step (forward, backward, clip,
update) with gradient accumulation, and the prefill and decode steps.
The reference also builds sharding trees over a mesh; the port trains
and serves on one card, so it has none.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import lm
from repro_torch.models.lm import ModelCfg
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.adafactor import AdafactorConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import tree_items, tree_leaves, tree_map


def make_optimizer(cfg: ModelCfg, lr: float | None = None):
    """(opt_cfg, init_fn, update_fn) for the arch's optimizer: Adafactor
    where ``cfg.optimizer`` names it, else AdamW with bf16 moments (the
    reference's choice for every arch)."""
    if cfg.optimizer == "adafactor":
        ocfg = AdafactorConfig(**({"lr": lr} if lr else {}))
        return (ocfg,
                lambda p: adafactor.adafactor_init(p, ocfg),
                lambda p, g, s, lr: adafactor.adafactor_update(
                    p, g, s, ocfg, lr))
    ocfg = AdamWConfig(moment_dtype=torch.bfloat16,
                       **({"lr": lr} if lr else {}))
    return (ocfg,
            lambda p: adamw.adamw_init(p, ocfg),
            lambda p, g, s, lr: adamw.adamw_update(p, g, s, ocfg, lr))


def value_and_grad(params, cfg: ModelCfg, batch):
    """((loss, metrics), grads) of ``lm.loss_fn``; grads mirror
    ``params`` (zeros for a leaf the loss does not reach)."""
    work = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(work)
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(work, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def accumulate_grad(params, cfg: ModelCfg, batch, acc) -> tuple:
    """(loss, metrics) of ``lm.loss_fn`` on ``batch``, its gradient added
    into the tree ``acc`` leaf by leaf as the backward produces each leaf's
    (``a.add_(g.to(a.dtype))``, the bits of adding a whole gradient tree)
    and freed at once, so at most one leaf's gradient lives beside the sum
    (a post-accumulate hook on each working leaf). A leaf the loss does
    not reach leaves its sum as it was."""
    work = tree_map(lambda p: p.detach().requires_grad_(), params)

    def add(a):
        def hook(w):
            a.add_(w.grad.to(a.dtype))
            w.grad = None
        return hook
    hooks = [w.register_post_accumulate_grad_hook(add(a))
             for (_, w), (_, a) in zip(tree_items(work), tree_items(acc))]
    try:
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(work, cfg, batch)
            loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def _microbatches(batch: dict, accum: int) -> list:
    """``accum`` microbatches of consecutive rows (the reference's
    reshape to [accum, B // accum, ...])."""
    out = []
    for i in range(accum):
        mb = {}
        for k, v in batch.items():
            n = v.shape[0] // accum
            mb[k] = v[i * n:(i + 1) * n]
        out.append(mb)
    return out


def make_train_step(cfg: ModelCfg, opt_cfg=None, *, lr: float | None = None,
                    warmup: int = 200, total_steps: int = 10000):
    """The training step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: forward and backward through ``lm.loss_fn``,
    then the arch's optimizer at ``warmup_cosine(step)`` of the base LR.
    The parameters and the optimizer state are updated in place and
    returned. With ``cfg.train_accum > 1`` the batch is split into
    microbatches run one after another, their gradients summed in
    ``cfg.accum_dtype`` and averaged, as the reference's scan does: each
    leaf's gradient goes into the sum as the backward produces it
    (``accumulate_grad``), so the sum is the only gradient tree (the bits
    of adding whole trees: one add per leaf and microbatch, onto zeros
    first)."""
    accum = cfg.train_accum
    _, _, opt_update = make_optimizer(cfg, lr)

    def train_step(params, opt_state, batch):
        if accum == 1:
            (loss, metrics), grads = value_and_grad(params, cfg, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=cfg.accum_dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            ms = []
            for mb in _microbatches(batch, accum):
                l, m = accumulate_grad(params, cfg, mb, grads)
                loss = loss + l
                ms.append(m)
            for _, a in tree_items(grads):
                a.div_(accum)
            loss = loss / accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        lr_scale = warmup_cosine(opt_state["step"], warmup=warmup,
                                 total=total_steps)
        params, opt_state, gn = opt_update(params, grads, opt_state,
                                           lr_scale)
        metrics = dict(metrics, loss=loss, grad_norm=gn)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelCfg, cache_len: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(cfg: ModelCfg):
    @torch.no_grad()
    def serve_step(params, tokens, cache):
        return lm.decode_step(params, cfg, tokens, cache)

    return serve_step
