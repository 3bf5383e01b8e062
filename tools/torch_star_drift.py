#!/usr/bin/env python3
"""How far the PyTorch port's bf16 STAR prefill, through its fused glue,
drifts from the plain STAR form across the layers of a model, and why.

    PYTHONPATH=src python tools/torch_star_drift.py        # smoke config, CPU
    python3 tools/torch_star_drift.py --full               # olmo_1b, one GPU

One random prompt (256 tokens on the smoke config, 2048 with ``--full``)
goes through ``lm.forward`` twice on the same weights (seed 0): with the
glue (``kernels.ops.star_attention_cfg``: K2 -> SADS -> K3; the kernels
on a GPU, their plain versions on the CPU), and with every layer's STAR
attention in the plain form (``core.star_attention_scanq`` per head).
One JSON line per layer:

- ``same_input_rows``: (head, q-tile) rows whose kept tile set differs
  between the glue and the plain selection on the glue run's own q/k;
- ``trajectory_rows``: rows whose kept tile set differs between the two
  runs, each selecting on its own q/k;
- ``k_changed`` / ``pow2_k_changed``: the share of K's elements that
  differ between the runs, before and after the pow2 quantisation;
- ``est_moved_steps``: the most any tile's predicted maximum moved
  between the runs, in bf16 steps of that maximum;
- ``edge_gap_steps``: for the rows that differ between the runs, how far
  the plain run's selection sat from its nearest decision edge (the
  keep-th against the next maximum, or the sphere's edge), in bf16 steps.

A last line gives the logits' largest gap between the runs, their
magnitude, and the share of positions whose argmax agrees; and, for
scale, the same between two dense forwards (``star=None``) that differ
only in rounding: K4 against the plain dense form.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core import dlzs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def compare(a, b) -> dict:
    """Two runs' logits [T, vocab]: the largest gap, the median over
    positions of each position's largest gap, and the share of positions
    whose argmax agrees."""
    gap = (a - b).abs()
    return {"logit_max_gap": float(gap.max()),
            "median_position_gap": float(np.median(
                gap.max(dim=-1).values.cpu().numpy())),
            "argmax_agreement": float((a.argmax(-1) == b.argmax(-1))
                                      .float().mean())}


def dense_logits(params, cfg, tokens, attend) -> torch.Tensor:
    """Logits [T, vocab] fp32 of a dense forward with ``attend`` as
    ``ops.flash``."""
    real = ops.flash
    ops.flash = attend
    try:
        logits = lm.forward(params, dataclasses.replace(cfg, star=None),
                            {"tokens": tokens})
    finally:
        ops.flash = real
    return logits[0, :, :cfg.vocab].float()


def run(params, cfg, tokens, attend) -> tuple:
    """(logits [T, vocab] fp32, each layer's (q, k)) of one forward with
    ``attend`` as every layer's STAR attention."""
    real, seen = ops.star_attention_cfg, []

    def recording(q, k, v, star, **kw):
        seen.append((q, k))
        return attend(q, k, v, star, **kw)

    ops.star_attention_cfg = recording
    try:
        logits = lm.forward(params, cfg, {"tokens": tokens})
    finally:
        ops.star_attention_cfg = real
    return logits[0, :, :cfg.vocab].float(), seen


@torch.inference_mode()
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="olmo_1b at full width on the GPU, 2048 tokens")
    args = ap.parse_args()
    if args.full:
        if not torch.cuda.is_available():
            print("torch_star_drift: --full needs a CUDA device",
                  file=sys.stderr)
            return 1
        cfg, dev, t = olmo_1b.config(), torch.device("cuda"), 2048
        build.build()
    else:
        torch.set_num_threads(2)
        cfg, dev, t = olmo_1b.smoke_config(), torch.device("cpu"), 256
    star = cfg.star
    if star.prefix_groups != 1:
        raise SystemExit("the selections here are over the whole prompt: "
                         "one prefix group only")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    params = lm.init(cfg, gen, dev)
    tokens = torch.as_tensor(cs.make_prompts(cfg, (t,), cs.SEED + 1)[0],
                             device=dev)[None]
    glue_logits, glue = run(params, cfg, tokens, ops.star_attention_cfg)
    plain_logits, plain = run(params, cfg, tokens, cs.plain_star)
    keep = star.keep_blocks(t)
    for i, ((qg, kg), (qp, kp)) in enumerate(zip(glue, plain)):
        kept_g = cs.glue_kept(qg, kg, star)
        bmax_g, kept_same = cs.plain_selection(qg, kg, star)
        bmax_p, kept_p = cs.plain_selection(qp, kp, star)
        moved = (kept_g != kept_p).any(dim=-1)
        live = bmax_p > cs.sads.NEG_INF / 2
        est = ((bmax_g.float() - bmax_p.float()).abs()
               / cs.bf16_step(bmax_p.float()))[live]
        gaps = cs.edge_gap_steps(bmax_p, keep, star.radius)[moved]
        print(json.dumps({
            "layer": i, "rows": moved.numel(),
            "same_input_rows": int((kept_g != kept_same).any(dim=-1).sum()),
            "trajectory_rows": int(moved.sum()),
            "k_changed": float((kg != kp).float().mean()),
            "pow2_k_changed": float((dlzs.pow2_quantize(kg)
                                     != dlzs.pow2_quantize(kp)).float()
                                    .mean()),
            "est_moved_steps": float(est.max()),
            "edge_gap_steps": sorted(float(g) for g in gaps)[:32]}),
            flush=True)
    dense = {"dense_" + k: v for k, v in compare(
        dense_logits(params, cfg, tokens, ops.flash),
        dense_logits(params, cfg, tokens, cs.plain_flash)).items()}
    print(json.dumps({
        "config": cfg.name, "T": t, "layers": cfg.n_layers, "keep": keep,
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
        else "cpu",
        "logit_abs_max": float(plain_logits.abs().max()),
        **compare(glue_logits, plain_logits), **dense}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
