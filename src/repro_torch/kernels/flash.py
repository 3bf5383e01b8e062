"""K4 — FlashAttention-2, the dense prefill, and its gradient: the CUDA
kernels ``csrc/flash.cu`` (forward) and ``csrc/flash_bwd.cu`` (backward)
behind checked wrappers, beside their plain PyTorch versions.

Replaces ``repro/kernels/flash.py::flash_attention`` (Pallas, TPU):
softmax attention over q [BH, T, d] and k/v [BH, S, d], causal at offset
``S − T``, with fp32 statistics. Unlike the TPU kernel it takes any T and
S (it masks the ragged edge itself). It is bound by operations at long T;
see the sources' headers. Tensors on the CPU take the plain versions
(``ref.flash_ref``, ``ref.flash_bwd_ref``); tensors on a GPU launch the
kernels (bf16) or raise.

``flash_attention`` is differentiable: where grad mode is on and q, k or
v requires grad it runs as ``_Flash`` (a ``torch.autograd.Function``),
whose forward keeps the row log-sum-exp and whose backward is
``flash_bwd``. The TPU kernel has no VJP (the reference trains through
XLA's dense softmax); on the card the backward is a kernel too, two
launches in one C call: a prep pass (D = rowsum(dO·O), lse in base 2) and
one ``wgmma`` + TMA pass over 128-key tiles that computes dK, dV and each
key tile's dQ partial, the partials summed into every query tile in a
fixed order (descending key tile), so two calls give the same bits.
``kernels.LAUNCHES["flash"]`` and ``["flash_bwd"]`` count launches
(one per call), ``kernels.FORM_LAUNCHES["flash/noncausal"]`` and
``["flash_bwd/noncausal"]`` those without the mask.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.ref import flash_bwd_ref, flash_ref  # plain forms


def _check(name: str, q, k, v) -> None:
    bh, t, d = q.shape
    s = k.shape[1]
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != bh \
            or k.shape[2] != d or t < 1 or s < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} must be [BH,T,d] and [BH,S,d]")
    launch.check_head_dim(name, d)


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """One forward call: o, or (o, lse [BH, T] fp32) ``with_lse``."""
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal=causal, scale=scale,
                         return_lse=with_lse)
    name = "flash"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k, v=v)
    _check(name, q, k, v)
    bh, t, d = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = launch.bind(name, "flash_bf16",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch(name, fn, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), bh, t, s, d,
                  s - t, int(causal), float(scale), causal=causal)
    return (out, lse) if with_lse else out


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None) -> tuple:
    """K4's gradient: (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output gradient ``do`` [BH, T, d], given the forward's output ``o``
    and fp32 ``lse`` [BH, T]. CPU tensors take ``ref.flash_bwd_ref``; on
    a GPU the kernel runs (bf16 operands, contiguous) or this raises."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal=causal, scale=scale)
    name = "flash_bwd"
    launch.require_cuda(name, q.device)
    launch.check_operands(name, q=q, k=k, v=v, o=o, do=do)
    _check(name, q, k, v)
    bh, t, d = q.shape
    s = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, t) \
            or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"{name}: o, do must be [BH,T,d] like q and lse "
                         f"fp32 contiguous [BH,T] on {q.device}; got o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # rows padded to the kernel's 64-row query tile: the dQ partial sums,
    # D and lse in base 2 per row (fp32), an order counter per query tile
    tp = -(-t // 64) * 64
    scratch = torch.empty(bh * tp * (d + 2) + bh * tp // 64,
                          dtype=torch.float32, device=q.device)
    fn = launch.bind(name, "flash_bwd_bf16",
                     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch(name, fn, q.device, *(x.data_ptr() for x in (
        q, k, v, o, lse, do, dq, dk, dv, scratch)), bh, t, s, d, s - t,
        int(causal), float(scale), causal=causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """K4 with its gradient: the forward saves q, k, v, o and the row
    log-sum-exp; the backward is ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_kv: int = 128,
                    return_lse: bool = False):
    """q [BH, T, d], k/v [BH, S, d] -> [BH, T, d] in q's dtype; with
    ``return_lse`` also the fp32 row log-sum-exp [BH, T] (natural base,
    +inf on a row that sees no key; not differentiable).

    ``block_q`` / ``block_kv`` are the TPU kernel's tiles, kept for its
    signature: the function does not depend on them, the plain version
    does not tile and the CUDA kernel tiles 128 x 128 itself."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if return_lse:
        if needs_grad:
            raise ValueError("flash_attention: return_lse is not "
                             "differentiable")
        return _forward(q, k, v, causal, scale, with_lse=True)
    if needs_grad:
        return _Flash.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, with_lse=False)
