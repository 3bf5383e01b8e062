"""End-to-end example of the PyTorch port: train a ~100M-param LM for a
few hundred steps with the full framework stack (synthetic data ->
prefetching loader -> fault-tolerant train loop -> checkpoints); the
twin of ``examples/train_star_lm.py``.

Run:  python examples/torch_train_star_lm.py [--steps 300] [--tiny]
      [--device cpu]

The default config is the 100M-class star_paper smoke model, trained
dense (``star_train`` off, as the JAX script trains it); ``--tiny``
shrinks it for quick runs. It runs on the GPU unless given ``--device
cpu``; the weights come from a seeded ``torch.Generator``. The train
loop resumes from the newest checkpoint in ``--ckpt`` if there is one.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import PrefetchLoader, SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.launch.shapes import params_specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import TrainLoopCfg, train_loop  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LR, WARMUP = 6e-4, 50


def model_cfg(tiny: bool = False):
    cfg = get_smoke_config("star_paper")
    if tiny:
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=2, n_heads=4,
                                  n_kv=4, d_ff=256)
    return cfg


def init_params(cfg, device):
    """Random weights from a generator seeded with 0."""
    return lm.init(cfg, torch.Generator(device=device).manual_seed(0),
                   device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=str(REPO / "build" / "star_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_cfg(args.tiny)
    n_params = sum(t.numel() for t in tree_leaves(params_specs(cfg)))
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params), "
          f"seq {args.seq}, batch {args.batch}, on {dev.type}")

    params = init_params(cfg, dev)
    _, opt_init, _ = launch_steps.make_optimizer(cfg)
    opt_state = opt_init(params)
    step_fn = launch_steps.make_train_step(cfg, lr=LR, warmup=WARMUP,
                                           total_steps=args.steps)
    ds = SyntheticLM(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch)
    loop_cfg = TrainLoopCfg(total_steps=args.steps, ckpt_every=100,
                            ckpt_dir=args.ckpt, log_every=10)
    params, opt_state, hist = train_loop(step_fn, params, opt_state,
                                         PrefetchLoader(ds, dev), loop_cfg)
    first, last = hist[0][1], hist[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'OK' if last < first else 'NO IMPROVEMENT'})")
    return {"device": str(dev), "arch": cfg.name, "n_params": n_params,
            "steps": args.steps, "seq": args.seq, "batch": args.batch,
            "history": hist, "first_loss": first, "last_loss": last}


if __name__ == "__main__":
    main()
