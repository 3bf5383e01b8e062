"""Paged KV-cache subsystem of the port (``repro.kvcache``'s twin).

``pool`` (host page pool, prefix index, swap area), ``allocator``
(admission, eviction, DLZS hot-set selection incl. the SADS sphere rule),
``bucketing`` (prompt buckets, chunk math) and ``wire`` (the flat-payload
swap format as the cross-instance transfer contract) are host-side copies
of the reference; ``metrics`` (DLZS page scores, byte prices), ``quant``
(the int8 cold tier: per-page-scaled mirrors of the pool slabs) and
``paged_attention`` (paged decode, dispatching to the CUDA kernel on a
GPU) run on tensors.
"""

from repro_torch.kvcache.allocator import PagedAllocator, select_hot_sphere
from repro_torch.kvcache.pool import (SCRATCH, PagePool, PoolExhausted,
                                      PoolStats, QuantStats, QuantTracker,
                                      SwapArea, SwapStats)
from repro_torch.kvcache.wire import payload_bytes, validate_payload

__all__ = ["PagePool", "PagedAllocator", "PoolExhausted", "PoolStats",
           "QuantStats", "QuantTracker", "SCRATCH", "SwapArea", "SwapStats",
           "payload_bytes", "select_hot_sphere", "validate_payload"]
