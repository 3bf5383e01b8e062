"""Dense feed-forward blocks (gated SwiGLU / GeLU / squared-ReLU).
PyTorch port of ``repro.models.mlp``."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    act: str = "silu"       # silu | gelu | relu | relu2
    gated: bool = True      # SwiGLU-style w3 gate
    dtype: torch.dtype = torch.bfloat16


def init(generator: torch.Generator, cfg: MLPCfg, device=None,
         n_layers=None):
    """FFN weights; ``n_layers`` stacks them on a leading axis."""
    lead = () if n_layers is None else (n_layers,)

    def w(fan_in, fan_out):
        return common.truncated_normal_init(
            generator, lead + (fan_in, fan_out), 1.0, cfg.dtype, device,
            fan_in=fan_in)

    p = {"w1": w(cfg.d_model, cfg.d_ff), "w2": w(cfg.d_ff, cfg.d_model)}
    if cfg.gated:
        p["w3"] = w(cfg.d_model, cfg.d_ff)
    return p


def apply(params, cfg: MLPCfg, x: torch.Tensor) -> torch.Tensor:
    """x [..., H] -> [..., H]."""
    act = common.activation(cfg.act)
    h = act(x @ params["w1"])
    if cfg.gated:
        h = h * (x @ params["w3"])
    return h @ params["w2"]
