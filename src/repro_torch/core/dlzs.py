"""DLZS — Differential Leading-Zero Scheme (paper §IV-A), PyTorch port of
``repro.core.dlzs``.

One operand (K) is reduced to ``sign(x)·2^floor(log2|x|)``; Q stays exact.
The reduced operand is stored as a 1-byte LZ code (``lz_pack``) so the
prediction stage streams a quarter of the bf16 bytes. Codes are computed
in fp32 through ``torch.frexp`` exactly as the JAX reference computes
them through ``jnp.frexp``, so both packages produce the same codes bit
for bit.

The integer-domain path (``int_quantize``, ``int_lz``,
``int_dlzs_value``; the paper's Eq. 3 on W-bit integers) takes the
exponent from ``torch.frexp`` too. The reference takes it from
``floor(log2(mag))`` and ``exp2``, which XLA's CPU build gets wrong at
some powers of two (``floor(log2(8192.))`` = 12, ``exp2(13.)`` =
8192.0039); the port's exponents and powers are exact.
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


def slzs_scores(q: torch.Tensor, k: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """Symmetric LZ scheme (FACT [9] baseline): BOTH operands
    pow2-quantized."""
    return dlzs_scores(pow2_quantize(q), pow2_quantize(k), scale)


def predict_khat(x: torch.Tensor, wk_pow2: torch.Tensor) -> torch.Tensor:
    """Cross-phase Key prediction (phase 1.1): K̂ = X · pow2(W_k), with
    ``wk_pow2`` converted once when the weights are made."""
    return torch.einsum("...th,hd->...td", x, wk_pow2)


# ---------------------------------------------------------------------------
# Int-domain faithful path (fidelity tests, op-count benchmarks).
# ---------------------------------------------------------------------------

def int_quantize(x: torch.Tensor, w: int = 8):
    """Symmetric per-tensor quantization to W-bit signed integers (held
    in x's float dtype). Returns (xi, scale)."""
    amax = torch.clamp(x.abs().max(), min=1e-30)
    scale = amax / (2.0 ** (w - 1) - 1)
    return torch.round(x / scale), scale


def _int_exponent(mag: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(mag, 1))), exact for every integer magnitude."""
    _, e = torch.frexp(torch.clamp(mag.float(), min=1.0))
    return e - 1


def int_lz(xi: torch.Tensor, w: int = 8) -> torch.Tensor:
    """Leading-zero count of the (w-1)-bit magnitude field (paper Eq. 3):
    LZ in [1, w], value ≈ sign · 2^(w − LZ); magnitude 0 maps to w."""
    mag = xi.abs()
    lz = (w - 1) - _int_exponent(mag)
    return torch.where(mag == 0, torch.full_like(lz, w), lz).to(torch.int32)


def int_dlzs_value(xi: torch.Tensor, w: int = 8) -> torch.Tensor:
    """sign · 2^(W−1−LZ') reconstruction of a W-bit int (mantissa -> 1),
    in fp32."""
    mag = xi.abs()
    val = torch.sign(xi).float() * torch.ldexp(
        torch.ones_like(mag, dtype=torch.float32), _int_exponent(mag))
    return torch.where(mag == 0, torch.zeros_like(val), val)
