"""Shard topology of the sequence-sharded serving runtime — PyTorch port of
``repro.spatial.topology``.

A ``ShardTopology`` describes the ring of shards one request is striped
across and the page -> shard ownership map. Pages are STRIPED (global
logical page ``j`` lives on shard ``j % n_shards``) so every shard holds
~1/N of any sequence's context: decode load stays balanced however a
prompt grows, and the DLZS tile grid (pages) aligns with shard boundaries
by construction.

The reference places one shard per XLA device of a 1-axis mesh and merges
the partial softmax states with pmax/psum over the mesh axis. The port
keeps every shard on ONE device (``make_mesh`` returns it): each shard's
pool is a slice of a leading shard axis, and the merge is a max and sums
over that axis. XLA fixes its device count at start-up, which is why the
reference also has ``ensure_host_devices`` and ``respawn_with_devices``;
torch has no such limit, so they have no counterpart here.

``neighbor_schedule`` exposes the MRCA per-step send lists (core/mrca.py)
so the exchange can be costed on a wrap-around-free mesh fabric.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import mrca
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardTopology:
    n_shards: int
    axis: str = "shards"

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {self.n_shards}")

    # -- page ownership (striping) -------------------------------------------

    def owner(self, logical_page: int) -> int:
        """Shard owning global logical page ``logical_page``."""
        return logical_page % self.n_shards

    def local_count(self, n_pages: int, shard: int) -> int:
        """How many of global pages [0, n_pages) land on ``shard``."""
        return (n_pages - shard + self.n_shards - 1) // self.n_shards

    def max_local_count(self, n_pages: int) -> int:
        return self.local_count(n_pages, 0) if n_pages else 0

    # -- placement -------------------------------------------------------------

    def make_mesh(self, device: Optional[Union[str, torch.device]] = None
                  ) -> torch.device:
        """The device every shard lives on (default ``cuda``; raises
        without one). The reference's 1-axis mesh of ``n_shards`` devices
        becomes the leading shard axis of tensors on this device."""
        return resolve_device(device)

    # -- communication schedule ----------------------------------------------

    def neighbor_schedule(self) -> list[list[mrca.Send]]:
        """MRCA per-step neighbor sends realizing the partial-state ring on
        a wrap-around-free 1-D mesh (paper Alg. 1), to cost the exchange;
        the merge itself runs over the shard axis on one device."""
        if self.n_shards == 1:
            return []
        return mrca.mrca_schedule(self.n_shards)

    def exchange_cost(self, hop_ns: float = 20.0,
                      chunk_bytes: float = 1.0) -> dict:
        """Latency/traffic of the MRCA exchange vs the naive forced ring."""
        if self.n_shards == 1:
            return {"mrca": {"latency_ns": 0.0, "hops": 0, "bytes": 0.0},
                    "naive_ring": {"latency_ns": 0.0, "hops": 0,
                                   "bytes": 0.0}}
        return {
            "mrca": mrca.schedule_cost(self.neighbor_schedule(), hop_ns,
                                       chunk_bytes),
            "naive_ring": mrca.schedule_cost(
                mrca.naive_ring_schedule(self.n_shards), hop_ns,
                chunk_bytes),
        }
