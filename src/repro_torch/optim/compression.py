"""Gradient compression with error feedback, for a reduction over a slow
link: the port of ``repro.optim.compression`` (same math, fp32).

Two standard compressors:

  * int8 block quantization (absmax scale per block) — 4x traffic cut;
  * top-k magnitude sparsification — k/N traffic.

Both keep a local error-feedback residual so the compression bias
vanishes over steps (Karimireddy et al., 2019). Trees are the port's
nested dicts of tensors. Top-k breaks ties toward the lower index, as
``jax.lax.top_k`` does (``core.sads.top_k_lower_index_ties``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sads import top_k_lower_index_ties
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionCfg:
    kind: str = "int8"          # int8 | topk | none
    block: int = 256            # int8 scale-block length
    topk_ratio: float = 0.05


def _int8_compress(x: torch.Tensor, block: int):
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[:torch.Size(shape).numel()].reshape(shape)


def _topk_compress(x: torch.Tensor, ratio: float):
    flat = x.float().reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    _, idx = top_k_lower_index_ties(flat.abs(), k)
    return flat[idx], idx


def _topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape):
    out = torch.zeros(torch.Size(shape).numel(), dtype=torch.float32,
                      device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def compress_leaf(g: torch.Tensor, ef, cfg: CompressionCfg):
    """Error-feedback compression of one gradient leaf. Returns (the
    decompressed gradient every participant reduces, the new residual)."""
    g32 = g.float() + (ef if ef is not None else 0.0)
    if cfg.kind == "int8":
        q, scale = _int8_compress(g32, cfg.block)
        ghat = _int8_decompress(q, scale, g32.shape)
    elif cfg.kind == "topk":
        vals, idx = _topk_compress(g32, cfg.topk_ratio)
        ghat = _topk_decompress(vals, idx, g32.shape)
    else:
        return g32.to(g.dtype), torch.zeros_like(g32)
    return ghat.to(g.dtype), g32 - ghat


def compress_tree(grads, ef_state, cfg: CompressionCfg):
    """Apply EF compression leaf-wise; ``ef_state`` None -> zeros.
    Returns (decompressed gradients, residuals), trees like ``grads``."""
    if ef_state is None:
        ef_state = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    pairs = tree_map(lambda g, e: compress_leaf(g, e, cfg), grads, ef_state)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def compressed_bytes(grads, cfg: CompressionCfg) -> int:
    """Wire bytes after compression (for a collective's time)."""
    total = 0
    for leaf in tree_leaves(grads):
        n = leaf.numel()
        if cfg.kind == "int8":
            total += n + 4 * (n // cfg.block + 1)
        elif cfg.kind == "topk":
            total += 8 * max(1, int(n * cfg.topk_ratio))
        else:
            total += 4 * n
    return total
