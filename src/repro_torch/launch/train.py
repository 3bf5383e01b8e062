"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [--full] [--device cpu] [--steps --seq --batch --lr --ckpt]``,
the twin of ``repro.launch.train``.

It runs the whole stack: ``SyntheticLM`` batches through the prefetching
loader (``data.PrefetchLoader``), the fault-tolerant loop
(``runtime.train_loop``) with async checkpoints, and the step from
``launch.steps.make_train_step`` (``lm.loss_fn`` with K4 and its backward
at every attention layer, then the arch's optimizer). Smoke configs by
default, on ``--device`` (default ``cuda``; pass ``--device cpu`` on a
machine without one); ``--full`` trains the published shape from random
weights (seed 0), e.g. OLMo-1B on one H100:

    python -m repro_torch.launch.train --arch olmo_1b --full --seq 2048

Encoder-decoder and embeddings-input archs are refused, as the reference
launcher refuses them. There is no ``--mesh``: the port trains on one
card.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import PrefetchLoader, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import steps as launch_steps
from repro_torch.models import lm
from repro_torch.runtime import TrainLoopCfg, train_loop


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="full published config vs smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt", default="build/train_ckpt")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.enc_layers or cfg.embeds_input:
        raise SystemExit(f"{args.arch}: use examples/ for enc-dec/VLM "
                         "training (frontend stubs)")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, dev)
    _, opt_init, _ = launch_steps.make_optimizer(cfg, args.lr)
    step_fn = launch_steps.make_train_step(cfg, lr=args.lr, warmup=20,
                                           total_steps=args.steps)
    ds = SyntheticLM(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch)
    loop = TrainLoopCfg(total_steps=args.steps, ckpt_every=50,
                        ckpt_dir=args.ckpt, log_every=10)
    _, _, hist = train_loop(step_fn, params, opt_init(params),
                            PrefetchLoader(ds, dev), loop)
    print(f"[train] {args.arch}: loss {hist[0][1]:.3f} -> "
          f"{hist[-1][1]:.3f} over {args.steps} steps")
    return {"arch": args.arch, "device": str(dev), "history": hist}


if __name__ == "__main__":
    main()
