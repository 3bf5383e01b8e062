"""K4 — FlashAttention-2, the dense prefill: the CUDA kernel
``csrc/flash.cu`` behind a checked wrapper, beside its plain PyTorch
version.

Replaces ``repro/kernels/flash.py::flash_attention`` (Pallas, TPU):
softmax attention over q [BH, T, d] and k/v [BH, S, d], causal at offset
``S − T``, with fp32 statistics. Unlike the TPU kernel it takes any T and
S (it masks the ragged edge itself). It is bound by operations at long T;
see the source's header. Tensors on the CPU take the plain version
(``ref.flash_ref``); tensors on a GPU launch the kernel (bf16) or raise.
``kernels.LAUNCHES["flash"]`` counts launches,
``kernels.FORM_LAUNCHES["flash/noncausal"]`` those without the mask.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.ref import flash_ref  # the plain version


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q [BH, T, d], k/v [BH, S, d] -> [BH, T, d] in q's dtype.

    ``block_q`` / ``block_kv`` are the TPU kernel's tiles, kept for its
    signature: the function does not depend on them, the plain version
    does not tile and the CUDA kernel tiles 64 x 64 itself."""
    bh, t, d = q.shape
    s = k.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal=causal, scale=scale)
    name = "flash"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k, v=v)
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != bh \
            or k.shape[2] != d or t < 1 or s < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} must be [BH,T,d] and [BH,S,d]")
    launch.check_head_dim(name, d)
    out = torch.empty_like(q)
    fn = launch.bind(name, "flash_bf16",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), bh, t, s, d, s - t,
                  int(causal), float(scale), causal=causal)
    return out
