"""Fault-tolerant training loop (``repro.runtime.train_loop``).

What a restarted job needs is the committed checkpoint, the
position-keyed data stream and the config hash. The loop resumes from
the latest COMMITTED step (the loader seeks to the exact batch index, so
the batches are the same bits), checkpoints asynchronously every
``ckpt_every`` steps, takes a failure injected at ``fail_at_step`` (the
recovery tests), and ends with a blocking save.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainLoopCfg:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "build/train_ckpt"
    keep: int = 3
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection (tests)


def train_loop(step_fn: Callable, params, opt_state, loader,
               cfg: TrainLoopCfg, *, config_hash: str = "",
               log_fn: Callable = print):
    """Run (and resume) training. Returns (params, opt_state, history):
    history holds (step, loss) at step 0 and every ``log_every`` steps."""
    ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep,
                        config_hash=config_hash)

    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = latest
        log_fn(f"[train_loop] resumed from step {latest}")
    loader.seek(start)

    history = []
    t0 = time.time()
    for step, batch in loader:
        if step >= cfg.total_steps:
            break
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            loader.stop()
            ckpt.wait()
            raise RuntimeError(f"injected failure at step {step}")
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % cfg.log_every == 0 or step == 0:
            loss = float(metrics["loss"])
            history.append((step, loss))
            log_fn(f"[train_loop] step {step} loss {loss:.4f} "
                   f"({(time.time() - t0):.1f}s)")
        if (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    loader.stop()
    ckpt.save(min(loader.step, cfg.total_steps),
              {"params": params, "opt": opt_state}, blocking=True)
    return params, opt_state, history
