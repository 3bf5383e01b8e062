"""Checks and the launch step shared by the prefill tile kernels' wrappers
(``kernels.dlzs``, ``kernels.sufa``, ``kernels.flash``).

A wrapper calls ``require_cuda`` once it knows its tensors are not on the
CPU, ``check_operands`` on what the kernel reads and writes, and
``launch`` to run the C entry point: it raises on a non-zero CUDA error
and only then counts the launch in ``kernels.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch import kernels
from repro_torch.kernels import build

HEAD_DIMS = (64, 128)     # head dims the tile kernels instantiate
MAX_TILE = 128            # largest tile; tiles are multiples of 16
WGMMA_TILE = 128          # K2's and K3's wgmma form takes these tiles only


def require_cuda(kernel: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")


def check_operands(kernel: str, **tensors: torch.Tensor) -> None:
    """bf16 operands on one device, contiguous and 16-byte aligned (the
    kernels copy rows to shared memory 16 bytes at a time), none of them
    asking for a gradient: a kernel's output carries none, so an operand
    that requires one would lose it without a word (K4 runs inside its
    ``autograd.Function``, where grad mode is off)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError(f"{kernel}: the kernel has no backward; its "
                           f"operands must not require grad")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel}: {name} must be bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             f"16-byte aligned")


def check_head_dim(kernel: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {d} not built; supported "
                         f"{HEAD_DIMS}")


def check_tile(kernel: str, name: str, size: int) -> None:
    if size <= 0 or size % 16 or size > MAX_TILE:
        raise ValueError(f"{kernel}: {name} = {size} must be a multiple of "
                         f"16 up to {MAX_TILE}")


def tile_form(block_q: int, block_kv: int) -> str:
    """K2's and K3's form for a tiling, by shape alone: ``wgmma`` (TMA and
    warpgroup products) for 128 x 128 tiles, ``mma_sync`` for the rest.
    Both of K3's forms carry its element-level sphere mask."""
    if block_q == block_kv == WGMMA_TILE:
        return "wgmma"
    return "mma_sync"


def bind(kernel: str, symbol: str, argtypes: list) -> Callable:
    """The C entry point ``symbol`` of library ``kernel`` (built at first
    use), returning the CUDA error code as an int."""
    fn = getattr(build.load(kernel), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, fn: Callable, device: torch.device, *args,
           form: str | None = None, causal: bool = True) -> None:
    """Run ``fn(*args, stream)`` on the device's current stream; raise if
    the launch reports a CUDA error, else count it (and its ``form``, for
    a kernel that has two, and ``noncausal`` for a prefill kernel run
    without the causal mask)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[kernel] += 1
    if form is not None:
        kernels.FORM_LAUNCHES[f"{kernel}/{form}"] += 1
    if not causal:
        kernels.FORM_LAUNCHES[f"{kernel}/noncausal"] += 1
