"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``. Libraries land in ``<repo>/build/``, named by a hash of the
source, the shared ``csrc/*.cuh`` headers and its flags, so an edited
source or header rebuilds and an unchanged one
loads as is. Building happens at first use; ``build()`` starts one
``nvcc`` per missing source, all at once, and raises if any fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build"

SOURCES = {"paged_decode": CSRC / "paged_decode.cu",
           "dlzs_block": CSRC / "dlzs_block.cu",
           "sufa": CSRC / "sufa.cu",
           "flash": CSRC / "flash.cu",
           "flash_bwd": CSRC / "flash_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the wgmma kernels (flash.cu, and the wgmma forms in dlzs_block.cu and
# sufa.cu) encode TMA tensor maps with cuTensorMapEncodeTiled, which
# libcuda provides; flash_bwd.cu includes the same header
EXTRA_FLAGS = {name: ("-lcuda",)
               for name in ("dlzs_block", "sufa", "flash", "flash_bwd")}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by the tile kernels
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[list[str]] = None) -> dict[str, dict]:
    """Compile every missing library of ``names`` (default: all) in
    parallel. Returns {name: {"seconds", "cached", "log"}}; raises
    RuntimeError with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        # libraries after the source: the linker may drop unneeded ones
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name]),
               *EXTRA_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, dst)
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
