"""DLZS — Differential Leading-Zero Scheme (paper §IV-A), PyTorch port of
``repro.core.dlzs``.

One operand (K) is reduced to ``sign(x)·2^floor(log2|x|)``; Q stays exact.
The reduced operand is stored as a 1-byte LZ code (``lz_pack``) so the
prediction stage streams a quarter of the bf16 bytes. Codes are computed
in fp32 through ``torch.frexp`` exactly as the JAX reference computes
them through ``jnp.frexp``, so both packages produce the same codes bit
for bit.
"""

from __future__ import annotations

import torch

# int8 LZ-code layout: code = sign(x) * (exponent + _BIAS); code 0 <=> x == 0.
_BIAS = 64
_EXP_MIN, _EXP_MAX = -63, 63


def pow2_quantize(x: torch.Tensor) -> torch.Tensor:
    """sign(x) · 2^floor(log2|x|): float-domain DLZS operand (mantissa -> 1).

    Quantization ratio q/x lies in (1/2, 1]: the estimate never overshoots
    and underestimates by at most 2x, preserving relative order well.
    """
    xf = x.float()
    _, e = torch.frexp(xf.abs())     # |x| = m * 2^e with m in [0.5, 1)
    q = torch.sign(xf) * torch.exp2((e - 1).float())
    return torch.where(xf == 0.0, torch.zeros_like(q), q).to(x.dtype)


def lz_pack(x: torch.Tensor) -> torch.Tensor:
    """Pack x into int8 LZ codes: sign * (floor(log2|x|) + 64); 0 -> 0."""
    xf = x.float()
    _, e = torch.frexp(xf.abs())
    e = torch.clamp(e - 1, _EXP_MIN, _EXP_MAX)
    code = torch.sign(xf) * (e + _BIAS).float()
    return torch.where(xf == 0.0, torch.zeros_like(code),
                       code).to(torch.int8)


def lz_unpack(code: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Decode int8 LZ codes back to sign·2^e floats."""
    c = code.float()
    mag = torch.exp2(c.abs() - _BIAS)
    return torch.where(c == 0.0, torch.zeros_like(mag),
                       torch.sign(c) * mag).to(dtype)


def dlzs_scores(q: torch.Tensor, k_pow2: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """Estimated scores Â = scale · Q · pow2(K)ᵀ (differential: Q exact).

    q: [..., T, d]; k_pow2: [..., S, d] already pow2-quantized.
    """
    return torch.einsum("...td,...sd->...ts", q, k_pow2) * scale
