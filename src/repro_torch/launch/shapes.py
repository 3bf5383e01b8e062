"""Assigned input shapes and shape-only stand-ins for them (``meta``
tensors: no allocation), the port of ``repro.launch.shapes``.

LM transformer shapes are (seq_len, global_batch); ``decode_*``/``long_*``
are one token against a seq_len KV cache, not a training step.
``long_500k`` applies only to sub-quadratic archs (SSM/hybrid), plus an
explicitly marked beyond-spec STAR sparse-decode cell. The reference's
logical sharding axes (``batch_logical_axes``, ``cache_logical_axes``)
have no counterpart on one card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import lm
from repro_torch.models.lm import ModelCfg
from repro_torch.tree import tree_map

# the prompt ``decode_specs`` runs: the decode cache is padded to the
# shape's seq_len whatever the prompt's length
_SPEC_PROMPT = 16


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelCfg) -> bool:
    return any(b.kind in ("mamba", "mlstm", "slstm") for b in cfg.pattern)


def applicability(cfg: ModelCfg, shape: ShapeCfg,
                  allow_star_long: bool = False) -> Optional[str]:
    """None if the (arch, shape) cell is in the official matrix, else the
    skip reason string."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        if allow_star_long and cfg.star is not None:
            return None  # beyond-spec STAR long-context cell
        return ("pure full-attention arch: long_500k skipped per spec "
                "(sub-quadratic attention required)")
    return None


def _spec(shape, dtype, device="meta") -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelCfg, shape: ShapeCfg, device="meta") -> dict:
    """The train/prefill batch of this (arch, shape) as empty tensors."""
    b, s = shape.batch, shape.seq
    specs = {}
    if cfg.enc_layers:
        # enc-dec (seamless): encoder frames stub + decoder tokens
        specs["enc_embeds"] = _spec((b, s, cfg.d_model), torch.bfloat16,
                                    device)
        specs["tokens"] = _spec((b, s), torch.int32, device)
    elif cfg.embeds_input:
        # VLM/audio stub: precomputed patch/frame embeddings
        specs["embeds"] = _spec((b, s, cfg.d_model), torch.bfloat16, device)
    else:
        specs["tokens"] = _spec((b, s), torch.int32, device)
    if shape.kind == "train":
        specs["labels"] = _spec((b, s), torch.int32, device)
    return specs


def decode_specs(cfg: ModelCfg, shape: ShapeCfg):
    """(tokens, cache tree) of the decode step as ``meta`` tensors, from
    ``lm.prefill`` itself run on fake tensors (shapes only, nothing
    allocated), so the cache structure can never drift from the model.
    The prompt is ``_SPEC_PROMPT`` tokens with ``cache_len`` the shape's
    seq; an encoder's frames, which set the cross-attention cache, run
    at full length."""
    b, s = shape.batch, shape.seq
    prompt = dataclasses.replace(shape, kind="prefill",
                                 seq=min(s, _SPEC_PROMPT))
    with FakeTensorMode(), torch.no_grad():
        params = tree_map(lambda t: _spec(t.shape, t.dtype, "cpu"),
                          params_specs(cfg))
        batch = batch_specs(cfg, prompt, "cpu")
        if cfg.enc_layers:
            batch["enc_embeds"] = _spec((b, s, cfg.d_model), torch.bfloat16,
                                        "cpu")
        _, cache = lm.prefill(params, cfg, batch, cache_len=s)
    cache = tree_map(lambda t: _spec(t.shape, t.dtype), cache)
    return _spec((b, 1), torch.int32), cache


@functools.lru_cache(maxsize=None)
def params_specs(cfg: ModelCfg):
    """The parameter tree on the ``meta`` device: no allocation."""
    return lm.init(cfg, torch.Generator(), torch.device("meta"))
