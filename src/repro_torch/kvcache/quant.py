"""int8 cold-page KV tier — PyTorch port of ``repro.kvcache.quant``.

Every attention cache dict (``{"k", "v", "k_lz", ...}``) of a pool with
the tier gains a quantized MIRROR of its fp slabs:

* ``kq``/``vq``           — int8 codes, the shape of ``k``/``v``;
* ``k_scale``/``v_scale`` — f32 per-(layer, page) absmax scales, shape
  ``k.shape[:-3]`` (``[L, P]``).

Pages quantize symmetrically (``scale = absmax / 127``, codes rounded half
to even and clipped to [-127, 127]), so an element's round trip is off by
at most ``scale / 2``. The fp rows stay intact: prefill past-page reads
stay exact, only the bounded decode gather reads the int8 tier
(``kvcache.paged_attention``, and K1's int8 form on the card). Which pages
hold a quantized copy is host bookkeeping (``pool.QuantTracker``).

The tree helpers are structural (any nesting of attention dicts); the
math runs on tensors. Where the reference returns new arrays, the port's
``quantize_pages`` writes the tier slabs in place, as every other pool
update of the port does.
"""

from __future__ import annotations

import torch

QUANT_KEYS = ("kq", "vq", "k_scale", "v_scale")
_EPS = 1e-8


def _is_attn(d) -> bool:
    return isinstance(d, dict) and "k" in d and "v" in d


def _map_attn(layers, fn):
    """Apply ``fn`` to every attention cache dict in the layer tree."""
    if _is_attn(layers):
        return fn(layers)
    if isinstance(layers, dict):
        return {k: _map_attn(v, fn) for k, v in layers.items()}
    return layers


def has_quant(layers) -> bool:
    """Does this layer tree carry the quantized tier?"""
    if _is_attn(layers):
        return "kq" in layers
    if isinstance(layers, dict):
        return any(has_quant(v) for v in layers.values())
    return False


def find_scale(layers):
    """First ``k_scale`` leaf in the tree (None when the tier is absent):
    ``quantize_pages`` writes every attention dict's scales for the same
    pages, so any one leaf answers "was this page quantized?"."""
    if _is_attn(layers):
        return layers.get("k_scale")
    if isinstance(layers, dict):
        for v in layers.values():
            s = find_scale(v)
            if s is not None:
                return s
    return None


def add_quant_slabs(layers):
    """Attach zeroed int8 slabs and per-page scales to every attention
    dict, on the device of its ``k``."""
    def add(d):
        out = dict(d)
        k = d["k"]
        out["kq"] = torch.zeros(k.shape, dtype=torch.int8, device=k.device)
        out["vq"] = torch.zeros(d["v"].shape, dtype=torch.int8,
                                device=k.device)
        sh = k.shape[:-3]               # drop (page, n_kv, head_dim)
        out["k_scale"] = torch.zeros(sh, dtype=torch.float32,
                                     device=k.device)
        out["v_scale"] = torch.zeros(sh, dtype=torch.float32,
                                     device=k.device)
        return out
    return _map_attn(layers, add)


def split_quant(layers):
    """(base, quant) of identical nesting: ``base`` holds the fp leaves,
    ``quant`` only the tier's. Lets code written against the fp structure
    (the prefill scatter, whose per-sequence cache has no tier) run
    untouched, with the tier merged back after."""
    def walk(d):
        if _is_attn(d):
            return ({k: v for k, v in d.items() if k not in QUANT_KEYS},
                    {k: v for k, v in d.items() if k in QUANT_KEYS})
        base, tier = {}, {}
        for k, v in d.items():
            base[k], tier[k] = walk(v)
        return base, tier
    return walk(layers)


def merge_quant(base, tier):
    """Inverse of ``split_quant``."""
    def walk(b, q):
        if _is_attn(b):
            return {**b, **q}
        return {k: walk(b[k], q[k]) for k in b}
    return walk(base, tier)


# -- quantization math ---------------------------------------------------------

def quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp page rows [..., page, n_kv, dh] -> (int8 codes, f32 scales [...]).

    Symmetric per-page absmax over the trailing (page, n_kv, dh) axes:
    ``scale = max(max|x|, 1e-8) / 127``, codes ``round(x / scale)``
    (half to even) clipped to [-127, 127]."""
    x = rows.float()
    amax = x.abs().amax(dim=(-1, -2, -3))
    scale = torch.clamp(amax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None, None, None]),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse map back to f32 (the decode gather's read path)."""
    return q.float() * scale[..., None, None, None]


def quantize_pages(layers, phys):
    """Write int8 copies of pages ``phys`` (page axis 1) into the tier
    slabs of every attention dict, in place; the fp rows stay intact.
    Idempotent on pages already quantized. Returns ``layers``."""
    idx = torch.as_tensor(phys, dtype=torch.long)

    def upd(d):
        at = idx.to(d["k"].device)
        for src, qk, sk in (("k", "kq", "k_scale"), ("v", "vq", "v_scale")):
            q, s = quantize_rows(d[src][:, at])
            d[qk][:, at] = q
            d[sk][:, at] = s
        return d
    _map_attn(layers, upd)
    return layers


def quantize_pages_sharded(layers, phys):
    """Spatial variant of ``quantize_pages``: leaves [L, S, P, ...] (the
    port's sharded slabs: the layer axis first, so each layer's [S, P,
    ...] slab is one block) and ``phys`` [S, N] shard-local page ids, one
    row per shard (padding on the scratch page). The reference vmaps
    ``quantize_pages`` over its [S, L, P, ...] slabs; here the shards fold
    into one page axis [L, S·P, ...] and one gather/scatter covers them,
    with the same codes and scales. Writes in place; returns ``layers``."""
    ids = torch.as_tensor(phys, dtype=torch.long)

    def upd(d):
        n_l, s, p = d["k"].shape[:3]
        at = ids.to(d["k"].device)
        at = (at + torch.arange(s, device=at.device)[:, None] * p
              ).reshape(-1)

        def flat(t):
            return t.view(n_l, s * p, *t.shape[3:])
        for src, qk, sk in (("k", "kq", "k_scale"), ("v", "vq", "v_scale")):
            q, scale = quantize_rows(flat(d[src])[:, at])
            flat(d[qk])[:, at] = q
            flat(d[sk])[:, at] = scale
        return d
    _map_attn(layers, upd)
    return layers
