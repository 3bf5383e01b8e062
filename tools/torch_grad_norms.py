#!/usr/bin/env python3
"""Where the gradient norm of ``chip_smoke.py``'s phase 21b comes from at
its last step, leaf by leaf and layer by layer, on the kernel path and
on the plain paths. One GPU:

    python3 tools/torch_grad_norms.py

OLMo-1B at full width and depth with ``star_train`` is trained 19 steps
as phase 21b trains it (seed 0, ``SyntheticLM`` at 8 x 2048, lr 6e-4,
warmup 5, a schedule of 20 steps). Then the 20th batch's gradient is
taken four ways on the same params (``chip_smoke.model_grads``): the
kernels; the plain versions in bf16 on the kernel run's tiles; the plain
versions in fp32 (fp32 copies of the params) on the same tiles; and
dense attention through K4 (``star=None``); and the plain versions on
the kernel run's tiles with layers 0 and 1 computed in fp32 and the rest
in bf16 (``fp32_first_layers``: their weights cast to fp32, the residual
stream fp32 from the embedding through layer 1's output, cast to bf16
there). One JSON line per path: its
loss, its global grad norm, each leaf's norm, the residual stream's
gradient norm at each layer's input and at the final norm's input, the
embedding's gradient summed in fp32 from the same rows, and the final
norm's input rows with the largest gradients (their token, the row's
spread and mean; the same rows in every path).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.models import lm  # noqa: E402

STEPS = 19
TOP_ROWS = 4
FP32_LAYERS = 2


@contextlib.contextmanager
def fp32_first_layers(n: int):
    """Within the block, the training stack computes its layers below
    ``n`` in fp32 (``lm._block_apply`` on fp32 casts of the layer's
    weights and input; the casts are differentiable, so each weight's
    gradient is rounded to bf16 once, at its leaf) and hands layer
    ``n - 1``'s output on in the model's dtype. A layer is known by its
    weights: ``lm._unbind_layers``' per-layer views, recorded as made."""
    real_block, real_unbind = lm._block_apply, lm._unbind_layers
    layer_of = {}

    def unbind(tree, count):
        out = real_unbind(tree, count)
        for i, sub in enumerate(out):
            for leaf in (cs.tree_leaves(sub) if isinstance(sub, dict)
                         else [sub]):
                layer_of[id(leaf)] = i
        return out

    def block(params, cfg, blk, x, positions, **kw):
        i = layer_of[id(cs.tree_leaves(params)[0])]
        if i >= n:
            return real_block(params, cfg, blk, x, positions, **kw)
        y, cache, aux = real_block(
            cs.tree_map(lambda t: t.float(), params),
            dataclasses.replace(cfg, dtype=torch.float32), blk, x.float(),
            positions, **kw)
        return (y.to(cfg.dtype) if i == n - 1 else y), cache, aux
    lm._block_apply, lm._unbind_layers = block, unbind
    try:
        yield
    finally:
        lm._block_apply, lm._unbind_layers = real_block, real_unbind


def traced_grads(params, cfg, batch, **kw) -> tuple:
    """``chip_smoke.model_grads`` with the residual stream's gradient
    recorded: at each layer's input, and at the final norm's input."""
    rec = {"layers": []}
    real_stack, real_remat = lm._train_stack, lm._remat

    def remat(fn, cfg_):
        run = real_remat(fn, cfg_)

        def hooked(x, i):
            x.register_hook(lambda g: rec["layers"].append(
                (i, float(g.float().norm()))))
            return run(x, i)
        return hooked

    def stack(blocks, cfg_, x, positions, **kws):
        x.register_hook(lambda g: rec.__setitem__("dx0", g.detach()))
        y, aux = real_stack(blocks, cfg_, x, positions, **kws)
        rec["xL"] = y.detach()
        y.register_hook(lambda g: rec.__setitem__("dxL", g.detach()))
        return y, aux
    lm._remat, lm._train_stack = remat, stack
    try:
        loss, _, grads = cs.model_grads(params, cfg, batch, **kw)
    finally:
        lm._remat, lm._train_stack = real_remat, real_stack
    return loss, grads, rec


def summary(name, loss, grads, rec, tokens, rows) -> dict:
    leaves = {cs._key_path(p): float(g.float().norm())
              for p, g in cs.sorted_items(grads)}
    dx0, dxl, xl = rec["dx0"].float(), rec["dxL"].float(), rec["xL"].float()
    d = dx0.shape[-1]
    embed32 = torch.zeros(grads["embed"].shape, dtype=torch.float32,
                          device=dx0.device)
    embed32.index_add_(0, tokens.reshape(-1), dx0.reshape(-1, d))
    row_norm = dxl.norm(dim=-1)
    if rows is None:
        rows = [divmod(int(r), row_norm.shape[1])
                for r in row_norm.flatten().topk(TOP_ROWS).indices]
    return {
        "path": name, "loss": float(loss),
        "grad_norm": float(cs.adamw.global_norm(grads)), "leaves": leaves,
        "layer_input_grad_norms": [n for _, n in sorted(rec["layers"])],
        "final_norm_input_grad_norm": float(dxl.norm()),
        "embed_grad_norm_fp32_sum": float(embed32.norm()),
        "top_rows": [{"b": b, "t": t, "token": int(tokens[b, t]),
                      "grad_norm": float(row_norm[b, t]),
                      "x_std": float(xl[b, t].std()),
                      "x_mean": float(xl[b, t].mean()),
                      "x_absmax": float(xl[b, t].abs().max())}
                     for b, t in rows],
    }, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_norms: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(olmo_1b.config(), star_train=True)
    gen = torch.Generator(device=dev)
    params, _ = cs.init_params(cfg, gen, dev)
    _, opt_init, _ = cs.launch_steps.make_optimizer(cfg, cs.TRAIN_LR)
    opt = opt_init(params)
    step = cs.launch_steps.make_train_step(
        cfg, lr=cs.TRAIN_LR, warmup=cs.TRAIN_WARMUP,
        total_steps=cs.TRAIN_STEPS)
    data = cs.SyntheticLM(vocab=cfg.vocab, seq=cs.TRAIN_SEQ,
                          global_batch=cs.TRAIN_BATCH)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
    for i in range(STEPS):
        params, opt, m = step(params, opt, batch_at(i))
        print(json.dumps({"step": i, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])}), flush=True)
    bt = batch_at(STEPS)
    tiles = []
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cs.tree_map(lambda t: t.float(), params)
    rows = None
    for name, p, c, first32, kw in (
            ("kernels", params, cfg, 0, {"plain": False, "tiles": tiles}),
            ("plain_bf16", params, cfg, 0, {"plain": True, "tiles": tiles}),
            ("plain_fp32", p32, cfg32, 0, {"plain": True, "tiles": tiles}),
            ("dense_k4", params, dataclasses.replace(cfg, star=None), 0,
             {"plain": False}),
            ("plain_bf16_layers01_fp32", params, cfg, FP32_LAYERS,
             {"plain": True, "tiles": tiles})):
        with fp32_first_layers(first32):
            loss, g, rec = traced_grads(p, c, bt, **kw)
        line, rows = summary(name, loss, g, rec, bt["tokens"], rows)
        print(json.dumps(line), flush=True)
        del g, rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
