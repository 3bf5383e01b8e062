"""K2 — DLZS block maxima: the CUDA kernel ``csrc/dlzs_block.cu`` behind a
checked wrapper, beside its plain PyTorch version.

Replaces ``repro/kernels/dlzs.py::dlzs_block_scores`` (Pallas, TPU): per
(query tile, key tile), the largest predicted score
``scale · Q · pow2(K)ᵀ`` under the causal mask at offset ``S − T``. Only
the [BH, n_qt, n_kt] fp32 maxima leave the kernel. It is bound by
operations at long T; see the source's header for its design. Two forms,
picked by shape alone (``launch.tile_form``): ``wgmma`` + TMA for the
served 128 x 128 tiles, ``mma_sync`` for other tiles (the pool probe's
16). Tensors on the CPU take the plain version (``ref.dlzs_block_ref``);
tensors on a GPU launch the kernel (bf16) or raise.
``kernels.LAUNCHES["dlzs_block"]`` counts launches,
``kernels.FORM_LAUNCHES`` each form's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.ref import dlzs_block_ref  # the plain version

_POW2_MASK = -8388608    # 0xFF800000 as int32: sign and exponent bits


def pow2_bitwise(x: torch.Tensor) -> torch.Tensor:
    """sign(x)·2^floor(log2|x|) by zeroing the f32 mantissa bits: the
    kernel's quantizer (for bf16 input it keeps the bits & 0xFF80)."""
    bits = x.float().view(torch.int32) & _POW2_MASK
    return bits.view(torch.float32)


def dlzs_block_scores(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      block_q: int = 128, block_kv: int = 128
                      ) -> torch.Tensor:
    """q [BH, T, d], k [BH, S, d] -> predicted block maxima
    [BH, T/block_q, S/block_kv] in fp32 (tiles clipped to T and S)."""
    bh, t, d = q.shape
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    block_q = min(block_q, t)
    block_kv = min(block_kv, s)
    if q.device.type == "cpu":
        return dlzs_block_ref(q, k, causal=causal, scale=scale,
                              block_q=block_q, block_kv=block_kv)
    name = "dlzs_block"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k)
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be [BH,T,d] and [BH,S,d]")
    launch.check_head_dim(name, d)
    launch.check_tile(name, "block_q", block_q)
    launch.check_tile(name, "block_kv", block_kv)
    if t % block_q or s % block_kv:
        raise ValueError(f"{name}: T={t}, S={s} must be multiples of the "
                         f"tiles {block_q} x {block_kv}")
    out = torch.empty((bh, t // block_q, s // block_kv), dtype=torch.float32,
                      device=q.device)
    form = launch.tile_form(block_q, block_kv)
    ptrs = (q.data_ptr(), k.data_ptr(), out.data_ptr())
    if form == "wgmma":
        fn = launch.bind(name, "dlzs_wgmma_bf16",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, d, int(causal), float(scale))
    else:
        fn = launch.bind(name, "dlzs_mma_bf16",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, bh, t, s, d, block_q, block_kv, int(causal),
                float(scale))
    launch.launch(name, fn, q.device, *args, form=form, causal=causal)
    return out
