#!/usr/bin/env python3
"""Phase 27 of ``chip_smoke.py`` alone: the configs the reference trains
that phases 20-25 never trained, trained on one GPU at their published
widths. Builds the attention kernels, then runs
``chip_smoke.check_untrained_training``: (a) K4's forward and backward at
BH 256 and 384 and K2, K3 and K3's backward at BH 256 (T 2048, d 128)
against their plain versions, timed; (b) one 2-layer step's gradients of
star_paper, ChatGLM3-6B and StarCoder2-15B, dense and with
``star_train``, by phase 20d's rule; (c) star_paper with ``star_train``
and ChatGLM3-6B dense and with ``star_train`` at full depth, StarCoder2-15B
cut to ``chip_smoke.STARCODER2_TRAIN_LAYERS`` layers, 12 steps of 8 x 2048
tokens each. Each check prints its JSON line; the card's name and power
limit come first.

    python3 tools/torch_untrained_train.py

(about 6 minutes on an H100 with the builds).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_untrained_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build(["dlzs_block", "sufa", "flash", "flash_bwd", "sufa_bwd"])
    cs.emit("build", seconds=time.perf_counter() - t0)
    dev = torch.device("cuda")
    cs.check_untrained_training(dev, torch.Generator(device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
