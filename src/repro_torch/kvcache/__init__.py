"""Paged KV-cache subsystem of the port (``repro.kvcache``'s twin).

``pool`` (host page pool, prefix index, swap area), ``allocator``
(admission, eviction, DLZS hot-set selection incl. the SADS sphere rule),
``bucketing`` (prompt buckets, chunk math) are host-side copies of the
reference; ``metrics`` (DLZS page scores, byte prices) and
``paged_attention`` (paged decode, dispatching to the CUDA kernel on a
GPU) run on tensors. The int8 cold tier (``quant``) and the wire format
of disaggregation (``wire``) are later slices (ROADMAP §1).
"""

from repro_torch.kvcache.allocator import PagedAllocator, select_hot_sphere
from repro_torch.kvcache.pool import (SCRATCH, PagePool, PoolExhausted,
                                      PoolStats, QuantStats, QuantTracker,
                                      SwapArea, SwapStats)

__all__ = ["PagePool", "PagedAllocator", "PoolExhausted", "PoolStats",
           "QuantStats", "QuantTracker", "SCRATCH", "SwapArea", "SwapStats",
           "select_hot_sphere"]
