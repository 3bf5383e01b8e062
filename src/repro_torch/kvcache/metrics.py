"""DLZS page scores + bytes accounting for the paged pool — PyTorch port
of ``repro.kvcache.metrics``.

``page_scores`` reduces the int8 LZ-code slab to one score per physical
page, max'd across layers, KV heads and head dims: |code| =
|floor(log2 |k|)| + bias, a query-agnostic upper bound on the DLZS score
any query can reach against the page. Pools without an LZ slab pack K on
the fly.
"""

from __future__ import annotations

import torch

from repro_torch.core import dlzs
from repro_torch.tree import leaves_by_key, tree_leaves


def _lz_leaves(cache_layers) -> list:
    lz = leaves_by_key(cache_layers, "k_lz")
    if not lz:
        lz = [dlzs.lz_pack(k) for k in leaves_by_key(cache_layers, "k")]
    if not lz:
        raise ValueError("no k/k_lz page pools in cache")
    return lz


def page_scores(cache_layers) -> torch.Tensor:
    """Per-physical-page DLZS score [n_pages] (int32): max |LZ code| over
    everything but the page axis of [L, n_pages, page, n_kv, dh] leaves."""
    per = [leaf.abs().amax(dim=(0, 2, 3, 4)).to(torch.int32)
           for leaf in _lz_leaves(cache_layers)]
    return torch.stack(per).amax(dim=0)


def page_scores_per_layer(cache_layers) -> torch.Tensor:
    """Per-(layer, page) DLZS score [n_layers, n_pages] (int32)."""
    per = [leaf.abs().amax(dim=(2, 3, 4)).to(torch.int32)
           for leaf in _lz_leaves(cache_layers)]
    return torch.cat(per, dim=0)


def _nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf (device-side cache footprint)."""
    return sum(_nbytes(leaf) for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


def bytes_per_page(cache_layers) -> int:
    """Bytes one physical page occupies across the whole layer stack."""
    leaves = [l for l in tree_leaves(cache_layers)
              if isinstance(l, torch.Tensor)]
    if not leaves:
        return 0
    return tree_bytes(cache_layers) // leaves[0].shape[1]


def gather_bytes_per_page(cache_layers) -> int:
    """Bytes the decode gather reads per hot page: the K and V rows only
    (LZ codes are never gathered by the decode path)."""
    kv = leaves_by_key(cache_layers, "k") + leaves_by_key(cache_layers, "v")
    if not kv:
        return 0
    return sum(_nbytes(l) for l in kv) // kv[0].shape[1]



def quant_bytes_per_page(cache_layers) -> int:
    """Bytes one page occupies in the int8 mirror tier (codes + scales);
    0 when the tier is absent."""
    qs = [leaf for key in ("kq", "vq", "k_scale", "v_scale")
          for leaf in leaves_by_key(cache_layers, key)]
    if not qs:
        return 0
    return sum(_nbytes(l) for l in qs) // qs[0].shape[1]
