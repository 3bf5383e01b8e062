"""Shared layer primitives: norms, activations, RoPE, initializers.
PyTorch port of ``repro.models.common`` (same math, same dtypes: norms
and RoPE compute in fp32 and cast back to the input dtype)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def truncated_normal_init(generator: torch.Generator, shape, scale,
                          dtype=torch.float32, device=None,
                          fan_in=None) -> torch.Tensor:
    """He/LeCun-style fan-in init: N(0,1) truncated to [-2, 2] times
    sqrt(scale / fan_in), drawn in fp32 from ``generator`` on ``device``.
    ``fan_in`` defaults to ``shape[0]``; a layer-stacked weight passes its
    own. (``jax.random`` streams cannot be reproduced, so the port's init
    draws the same distribution, not the same numbers.)"""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    std = (scale / max(1, fan_in)) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)    # in place: one fp32 draw at a time


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, parametric: bool = True,
                   device=None):
    if not parametric:   # OLMo's non-parametric LN
        return {}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if "scale" in params:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype, device)
    if kind == "layernorm":
        return layernorm_init(d, dtype, parametric=True, device=device)
    if kind == "nonparametric_ln":
        return layernorm_init(d, dtype, parametric=False, device=device)
    raise ValueError(f"unknown norm {kind}")


def norm_apply(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(params, x)
    return layernorm_apply(params, x)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s composition, op by op — x * (1 / (1 + exp(-x))) —
    so bf16 rounds after each op exactly where the reference rounds."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def activation(kind: str):
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "silu":
        return silu
    if kind == "relu":
        return F.relu
    if kind == "relu2":  # Nemotron-4 squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {kind}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(rotary_dim: int, theta: float, device=None):
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                             device=device) / rotary_dim
    return 1.0 / (theta ** exponents)  # [rotary_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4,
               rotary_fraction: float = 1.0) -> torch.Tensor:
    """Rotate pairs (x[2i], x[2i+1]) of the first ``rotary_fraction`` of
    dims. x: [..., S, n_heads, head_dim]; positions broadcastable to
    [..., S]."""
    head_dim = x.shape[-1]
    rotary_dim = int(head_dim * rotary_fraction)
    rotary_dim -= rotary_dim % 2
    if rotary_dim == 0:
        return x
    freqs = rope_frequencies(rotary_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs       # [..., S, rd/2]
    cos = torch.cos(angles)[..., :, None, :]            # broadcast heads
    sin = torch.sin(angles)[..., :, None, :]
    xr = x[..., :rotary_dim].float()
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rotary_dim:]], dim=-1)
