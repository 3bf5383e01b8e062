#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: Nemotron-4-340B trained at
head_dim 192 on one GPU. Builds the attention kernels (printing ptxas's
registers and spills for K4's and K3's backwards), then runs
``chip_smoke.check_nemotron_training``: (a) both backwards at the
training shape against their plain versions, timed, with their kernels'
device times from a profiler trace; (b) one layer's
gradient at published width, dense and with ``star_train``; (c) 1 of 96
layers trained with Adafactor and ``train_accum`` 8, dense and with
``star_train``. Each check prints its JSON line; the card's name and power
limit come first.

    python3 tools/torch_nemotron_train.py [LR]

(about 4 minutes on an H100 after the builds). LR, the base learning
rate of (c), defaults to the phase's (``chip_smoke.NEMOTRON_TRAIN_LR``):
the runs that chose it.
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


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("torch_nemotron_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    built = build.build(["dlzs_block", "sufa", "flash", "flash_bwd",
                         "sufa_bwd"])
    cs.emit("build", seconds=time.perf_counter() - t0)
    for name in ("flash_bwd", "sufa_bwd"):
        for fn, line in cs.ptxas_report(built[name]["log"]):
            print(f"ptxas[{name}] {fn} {line}", flush=True)
    dev = torch.device("cuda")
    lr = float(argv[0]) if argv else cs.NEMOTRON_TRAIN_LR
    cs.check_nemotron_training(cs.nemotron_4_340b.config(), dev,
                               torch.Generator(device=dev), lr=lr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
