"""Per-shard page pools + striped block tables for the spatial engine —
PyTorch port of ``repro.spatial.sharded_pool`` (host bookkeeping only).

Layers one ``kvcache.PagePool`` + ``PagedAllocator`` per shard under a
single allocation interface keyed by GLOBAL logical page indices: page
``j`` of a sequence lives on shard ``topology.owner(j) = j % n_shards``
and its block-table entry is a physical id *within that shard's pool*.
Aggregate KV capacity is therefore ``n_shards x (n_pages_local - 1)``
pages — context length scales with device count, the spatial deployment's
core claim.

Everything the single-pool allocator does carries over per shard:

* prefix sharing — a full prompt page's token-prefix key is registered in
  its OWNER shard's index. Striping is deterministic, so identical
  prompts map identical pages to identical shards and the lookup hits.
* DLZS retention — ``metrics.page_scores`` runs over the stacked slabs
  (one reduction, a score vector per shard); eviction and hot-page
  selection use each shard's own score vector.
* preemption accounting — ``held_pages`` counts uniquely-owned pages,
  optionally restricted to one shard so the scheduler can pick a victim
  that actually frees memory on the STARVED shard.

``PoolExhausted`` raised here carries ``.shard`` so the engine can
translate pressure into a shard-tagged ``NeedPages``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.kvcache import PagePool, PagedAllocator, PoolExhausted
from repro_torch.spatial.topology import ShardTopology


class ShardPoolExhausted(PoolExhausted):
    """One shard's pool ran dry (``.shard`` names it)."""

    def __init__(self, shard: int, msg: str = ""):
        super().__init__(msg or f"shard {shard} pool exhausted")
        self.shard = shard


class ShardedPagePools:
    def __init__(self, topo: ShardTopology, n_pages_local: int,
                 page_size: int, *, recent_pages: int = 2):
        self.topo = topo
        self.page_size = page_size
        self.n_pages_local = n_pages_local
        self.pools = [PagePool(n_pages_local, page_size)
                      for _ in range(topo.n_shards)]
        self.allocs = [PagedAllocator(pool, recent_pages=recent_pages)
                       for pool in self.pools]

    # -- capacity ------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.topo.n_shards

    def capacity_pages(self) -> int:
        """Aggregate usable pages across every shard."""
        return self.n_shards * (self.n_pages_local - 1)

    def fits(self, n_pages: int) -> bool:
        """Can a single sequence of ``n_pages`` striped pages ever fit?
        Per-shard, not just in aggregate: striping puts
        ``local_count(n_pages, s)`` pages on shard ``s``."""
        return all(self.topo.local_count(n_pages, s) <= self.n_pages_local - 1
                   for s in range(self.n_shards))

    def free_pages(self, shard: int) -> int:
        return self.pools[shard].free_pages()

    def reclaimable(self, shard: int) -> int:
        return (self.pools[shard].free_pages()
                + len(self.pools[shard].evictable()))

    # -- admission / growth (global-logical-page addressing) -----------------

    def admit_chunk(self, toks, start_page: int, n_pages: int,
                    scores: Optional[np.ndarray] = None, *,
                    sharing: bool = True
                    ) -> tuple[list[int], list[int], bool]:
        """Map global prompt pages [start_page, start_page + n_pages) onto
        their owner shards' pools, prefix-sharing full pages.

        ``toks`` is the effective-prompt key tuple (or None when sharing is
        off); ``scores`` [n_shards, n_pages_local] are per-shard DLZS page
        scores for eviction. Returns (pages, fresh_globals, sharing):
        ``pages`` are shard-local physical ids in global-page order,
        ``fresh_globals`` the GLOBAL indices the caller must compute+write.
        Rolls the whole chunk back on exhaustion (raising
        ShardPoolExhausted with the starved shard).
        """
        page = self.page_size
        t = len(toks) if toks is not None else 0
        pages: list[int] = []        # shard-local phys, global order
        fresh: list[int] = []        # global logical indices
        taken: list[tuple[int, int]] = []   # (shard, phys) for rollback
        try:
            for j in range(start_page, start_page + n_pages):
                s = self.topo.owner(j)
                end = (j + 1) * page
                if sharing and toks is not None and end <= t:
                    hit = self.pools[s].lookup(tuple(toks[:end]))
                    if hit is not None:
                        pages.append(hit)
                        taken.append((s, hit))
                        continue
                sharing = False
                pid = self.allocs[s].extend(
                    scores[s] if scores is not None else None)
                pages.append(pid)
                fresh.append(j)
                taken.append((s, pid))
        except PoolExhausted:
            starved = s                  # before rollback rebinds anything
            for ts, pid in taken:
                self.pools[ts].decref(pid)
            raise ShardPoolExhausted(starved) from None
        return pages, fresh, sharing

    def register_prompt_pages(self, toks, table: Sequence[int],
                              fresh_globals: Sequence[int]) -> None:
        """Index freshly-written FULL prompt pages in their owner shard."""
        page = self.page_size
        for j in fresh_globals:
            end = (j + 1) * page
            if end <= len(toks):
                self.pools[self.topo.owner(j)].register(
                    tuple(toks[:end]), table[j])

    def extend(self, logical_page: int,
               scores: Optional[np.ndarray] = None) -> int:
        """One fresh decode page at global index ``logical_page``."""
        s = self.topo.owner(logical_page)
        try:
            return self.allocs[s].extend(
                scores[s] if scores is not None else None)
        except PoolExhausted:
            raise ShardPoolExhausted(s) from None

    def release(self, table: Sequence[int]) -> None:
        """Drop a sequence's references, each page on its owner shard."""
        for j, pid in enumerate(table):
            self.pools[self.topo.owner(j)].decref(pid)

    def ensure_owned(self, table: list[int], idx: int
                     ) -> Optional[tuple[int, int, int]]:
        """COW guard before writing global page ``idx``; returns
        (shard, src, dst) local ids when a copy is needed."""
        s = self.topo.owner(idx)
        pid = table[idx]
        if self.pools[s].ref(pid) < 2:
            return None
        new = self.pools[s].cow(pid)
        table[idx] = new
        return s, pid, new

    # -- decode working set ---------------------------------------------------

    def local_pages(self, table: Sequence[int], shard: int
                    ) -> tuple[list[int], list[int]]:
        """(physical ids, global logical indices) of ``shard``'s slice of a
        block table, ascending."""
        globals_ = list(range(shard, len(table), self.n_shards))
        return [table[j] for j in globals_], globals_

    def select_hot(self, table: Sequence[int], shard: int, width: int,
                   scores: Optional[np.ndarray] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """<= ``width`` hot pages of ``shard``'s slice: the shard-local
        DLZS retention policy (newest local pages always hot, best-scored
        cold pages fill the rest). Returns (phys, GLOBAL logical)."""
        phys_l, globals_ = self.local_pages(table, shard)
        phys, local_idx = self.allocs[shard].select_hot(
            phys_l, width, scores[shard] if scores is not None else None)
        logical = np.full_like(local_idx, -1)
        ok = local_idx >= 0
        logical[ok] = np.asarray(globals_, np.int32)[local_idx[ok]]
        return phys, logical

    def select_hot_sphere(self, table: Sequence[int], shard: int,
                          width: int,
                          scores: Optional[np.ndarray] = None, *,
                          radius: Optional[float] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Bounded sphere-rule hot selection over ``shard``'s slice
        (see ``kvcache.allocator.select_hot_sphere``). Returns
        (shard-local phys, GLOBAL logical); a shard whose slice holds no
        sphere-qualified pages comes back all -1: K1's stats form then
        exits early for it and feeds the merge the neutral state."""
        phys_l, globals_ = self.local_pages(table, shard)
        phys, local_idx = self.allocs[shard].select_hot_sphere(
            phys_l, width, scores[shard] if scores is not None else None,
            radius=radius)
        logical = np.full_like(local_idx, -1)
        ok = local_idx >= 0
        logical[ok] = np.asarray(globals_, np.int32)[local_idx[ok]]
        return phys, logical

    # -- preemption accounting ------------------------------------------------

    def held_pages(self, table: Sequence[int],
                   shard: Optional[int] = None) -> int:
        """Pages preempting this table would actually free (ref == 1),
        optionally only those on ``shard``. Negative entries (the
        lazy-swap SHED sentinel — content parked on the host) are
        skipped: ref(-1) would silently read the LAST page's refcount."""
        return sum(
            1 for j, pid in enumerate(table)
            if pid >= 0
            and (shard is None or self.topo.owner(j) == shard)
            and self.pools[self.topo.owner(j)].ref(pid) == 1)

    # -- stats ----------------------------------------------------------------

    def stats(self) -> dict:
        per = [pool.stats() for pool in self.pools]
        return {
            "per_shard": per,
            "capacity": self.capacity_pages(),
            "live": sum(s.live for s in per),
            "free": sum(s.free for s in per),
            "peak_live": sum(s.peak_live for s in per),
            "shared_hits": sum(s.shared_hits for s in per),
            "evictions": sum(s.evictions for s in per),
            "cow_copies": sum(s.cow_copies for s in per),
        }
