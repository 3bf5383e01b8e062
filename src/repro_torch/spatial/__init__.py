"""Spatial serving runtime of the port: the sequence-sharded engine
(``repro.spatial``'s twin).

* ``topology``     — the shard ring: striped page -> shard ownership and
                     the MRCA neighbor schedule that costs the
                     partial-state exchange on a wrap-around-free mesh.
* ``sharded_pool`` — one ``kvcache`` page pool per shard behind a
                     global-logical-page interface: prefix sharing,
                     DLZS-scored eviction and hot-page retention run per
                     shard; capacity = n_shards x local pool.
* ``engine``       — ``SpatialServingEngine``: chunked prefill merges
                     each shard's partial softmax (m, l, o) state over
                     its resident past pages; decode runs K1's
                     unnormalised (m, l, o) form over every shard's hot
                     pages in one launch and merges the states.

Every shard lives on one device: the reference's mesh axis is a leading
shard axis of the pool slabs, and its pmax/psum merge is a max and
shard-order sums over that axis. The reference's
``ensure_host_devices``/``respawn_with_devices`` exist because XLA fixes
its device count at start-up; torch has no such limit, so they have no
counterpart. The serve loop is ``serving.api.LLM``
(``LLM.from_config(cfg, backend="spatial")``).
"""

from repro_torch.spatial.engine import (SpatialBackend, SpatialEngineCfg,
                                        SpatialServingEngine)
from repro_torch.spatial.sharded_pool import (ShardedPagePools,
                                              ShardPoolExhausted)
from repro_torch.spatial.topology import ShardTopology

__all__ = ["ShardPoolExhausted", "ShardTopology", "ShardedPagePools",
           "SpatialBackend", "SpatialEngineCfg", "SpatialServingEngine"]
