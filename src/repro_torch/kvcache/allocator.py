"""DLZS-guided admission, eviction and hot-page retention policies.

The policy layer between the host-side ``PagePool`` and the engine:

* ``admit``   — map a prompt onto page ids, sharing full-page prefixes via
  the pool's prefix index and allocating the rest (evicting cold cached
  pages when the free list runs dry).
* ``extend``  — grow a sequence by one decode page.
* ``select_hot`` — pick the ``W`` pages a sparse decode step actually
  gathers: the most recent ``recent`` pages are always hot (local window +
  the page being written), the remaining slots go to the highest
  DLZS-scored cold pages. Scores are the per-page max |int8 LZ code| of the
  cached keys (kvcache.metrics) — the paper's §IV-A prediction signal
  repurposed at page granularity: a page whose keys all have small log
  magnitude cannot produce a large Q·K̂ estimate for any query, so it is
  the safest page to leave cold. This is the cross-stage tie-in: the same
  LZ codes the decode predictor streams also drive cache retention.
* eviction — cached (ref-0) prefix pages are evicted lowest-score-first,
  so admission pressure reclaims the least attention-relevant memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.kvcache.pool import PagePool, PoolExhausted


def sphere_keep(scores, radius: float):
    """SADS sphere rule over per-page DLZS scores.

    Keeps every page whose predicted max is within ``radius`` of the best
    page: ``scores >= max(scores) - radius``. Returns a boolean mask of
    the same shape. This is the paper's score-sphere criterion — decode
    selectors bound the resulting set to a fixed hot width, but the
    sphere is the admission test.
    """
    s = np.asarray(scores)
    return s >= (s.max() - radius)


def select_hot_sphere(pages: Sequence[int], width: int,
                      scores: Optional[np.ndarray] = None, *,
                      recent: int = 1, radius: Optional[float] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Decode hot-set selection: SADS sphere rule under a hard width cap.

    Builds one priority-ordered candidate list and truncates it to
    ``width``, which gives the properties the decode path (and the
    property tests) rely on by construction:

    * deterministic — same inputs, same hot set;
    * monotone in ``width`` — a wider budget keeps a superset, so quality
      degrades smoothly as the cap tightens;
    * the NEWEST resident page (being written this step) and the SINK
      page (page 0 — attention sinks live there) are always hot;
    * fixed ``[width]`` output shapes padded with -1, so the single
      decode compile survives any score distribution;
    * SHED/parked entries (negative ids) are never selected.

    Priority: newest page, then sink, then the rest of the ``recent``
    local window (newest first), then cold pages that pass the sphere
    rule (``score >= max - radius``; see ``sphere_keep``)
    ordered by score descending with ties to the newest page. With
    ``radius=None`` every cold page is a candidate and the rule reduces
    to bounded top-k; with ``scores=None`` cold pages rank by recency.
    Output logical indices are sorted ascending so gathered rows stay
    position-ordered.
    """
    phys = np.full((width,), -1, np.int32)
    logical = np.full((width,), -1, np.int32)
    present = [j for j, pid in enumerate(pages) if pid >= 0]
    if not present or width <= 0:
        return phys, logical
    r = max(1, int(recent))
    prio = [present[-1]]                     # newest: always hot
    if present[0] != present[-1]:
        prio.append(present[0])              # sink: always hot
    for j in reversed(present[-r:-1]):       # rest of the local window
        if j not in prio:
            prio.append(j)
    seen = set(prio)
    rest = [j for j in present if j not in seen]
    if scores is None:
        rest.reverse()                       # no signal: newest-first
    elif rest:
        s_present = np.asarray(
            [float(scores[pages[j]]) for j in present], np.float64)
        if radius is not None:
            inside = np.asarray(sphere_keep(s_present, float(radius)))
            ok = {j for j, m in zip(present, inside) if m}
            rest = [j for j in rest if j in ok]
        sv = {j: float(scores[pages[j]]) for j in rest}
        rest.sort(key=lambda j: (-sv[j], -j))
    prio.extend(rest)
    keep = sorted(prio[:width])
    phys[:len(keep)] = [pages[j] for j in keep]
    logical[:len(keep)] = keep
    return phys, logical


class PagedAllocator:
    def __init__(self, pool: PagePool, *, recent_pages: int = 2):
        self.pool = pool
        self.recent = max(1, recent_pages)

    # -- admission / growth -------------------------------------------------

    def _alloc_or_evict(self, scores: Optional[np.ndarray]) -> int:
        """Allocate a page, evicting the lowest-scored cached page if
        needed."""
        if self.pool.free_pages() == 0:
            cached = self.pool.evictable()
            if not cached:
                raise PoolExhausted("no free and no cached pages")
            if scores is None:
                victim = cached[0]
            else:
                victim = min(cached, key=lambda p: float(scores[p]))
            self.pool.evict(victim)
        return self.pool.alloc()

    @staticmethod
    def _as_key_tokens(prompt: Sequence[int]) -> tuple:
        """Prompt as the int tuple the prefix index is keyed by. Callers
        on a per-chunk hot path pass a prebuilt tuple so the O(T)
        conversion happens once per prompt, not once per chunk."""
        return prompt if type(prompt) is tuple \
            else tuple(int(x) for x in prompt)

    def admit(self, prompt: Sequence[int],
              scores: Optional[np.ndarray] = None
              ) -> tuple[list[int], list[int], int]:
        """Map a whole prompt to pages. Returns (pages, fresh_pages,
        n_shared) — one ``admit_chunk`` covering every page.

        Full prompt pages are prefix-shared when an identical token prefix
        is already pooled; ``fresh_pages`` lists the pages the caller must
        write (and may register). On PoolExhausted every page taken so far
        is rolled back, so a deferred request retries cleanly later.
        """
        n_pages = -(-len(prompt) // self.pool.page_size)
        pages, fresh, n_shared, _ = self.admit_chunk(prompt, 0, n_pages,
                                                     scores)
        return pages, fresh, n_shared

    def admit_chunk(self, prompt: Sequence[int], start_page: int,
                    n_pages: int, scores: Optional[np.ndarray] = None, *,
                    sharing: bool = True
                    ) -> tuple[list[int], list[int], int, bool]:
        """Incremental ``admit``: map prompt pages ``[start_page,
        start_page + n_pages)`` only (one prefill chunk's worth).

        ``sharing`` carries the caller's prefix-share state across chunks —
        a page can only hit the index if every shallower page did, so once a
        chunk sees a miss the flag comes back False and later chunks skip
        the lookup. Returns (pages, fresh_pages, n_shared, sharing).
        Rolls back this chunk's pages on PoolExhausted, leaving earlier
        chunks' pages (owned by the caller) untouched.
        """
        page = self.pool.page_size
        t = len(prompt)
        # the key tuple is only needed while sharing is live — callers
        # with sharing disabled skip the O(T) conversion entirely
        toks = self._as_key_tokens(prompt) if sharing else None
        pages: list[int] = []
        fresh: list[int] = []
        n_shared = 0
        try:
            for i in range(start_page, start_page + n_pages):
                end = (i + 1) * page
                if sharing and end <= t:
                    hit = self.pool.lookup(toks[:end])
                    if hit is not None:
                        pages.append(hit)
                        n_shared += 1
                        continue
                sharing = False
                pid = self._alloc_or_evict(scores)
                pages.append(pid)
                fresh.append(pid)
        except PoolExhausted:
            for pid in pages:
                self.pool.decref(pid)
            raise
        return pages, fresh, n_shared, sharing

    def register_prompt_pages(self, prompt: Sequence[int],
                              pages: Sequence[int],
                              fresh: Sequence[int],
                              start_page: int = 0) -> None:
        """Index freshly-written FULL prompt pages for future sharing.
        ``pages`` covers prompt pages starting at ``start_page`` (nonzero
        for chunked prefill, where each chunk registers its own pages)."""
        page = self.pool.page_size
        toks = self._as_key_tokens(prompt)
        fresh_set = set(fresh)
        for i, pid in enumerate(pages):
            end = (start_page + i + 1) * page
            if end <= len(toks) and pid in fresh_set:
                self.pool.register(toks[:end], pid)

    def extend(self, scores: Optional[np.ndarray] = None) -> int:
        """One fresh decode page (never shared, never indexed)."""
        return self._alloc_or_evict(scores)

    def release(self, pages: Sequence[int]) -> None:
        """Drop a finished sequence's references; indexed pages stay
        cached."""
        for pid in pages:
            self.pool.decref(pid)

    def ensure_owned(self, pages: list[int], idx: int
                     ) -> Optional[tuple[int, int]]:
        """COW guard before writing ``pages[idx]``: if shared, detach onto a
        fresh page and return ``(src, dst)`` — the caller must copy device
        content src -> dst. None when the page was already private."""
        pid = pages[idx]
        if self.pool.ref(pid) < 2:
            return None
        new = self.pool.cow(pid)
        pages[idx] = new
        return pid, new

    # -- retention ----------------------------------------------------------

    def select_hot(self, pages: Sequence[int], width: int,
                   scores: Optional[np.ndarray] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Choose <= ``width`` pages for the decode gather.

        Returns (phys, logical) int32 arrays of length ``width``, padded
        with -1; ``logical`` values index into ``pages``. Logical order
        is preserved (ascending positions) so the gathered rows stay
        position-sorted. Entries with a negative id (the lazy-swap SHED
        sentinel — content parked on the host) are never hot: the
        selection runs over the resident pages only.
        """
        phys = np.full((width,), -1, np.int32)
        logical = np.full((width,), -1, np.int32)
        present = np.asarray([j for j, pid in enumerate(pages) if pid >= 0],
                             np.int32)
        n = len(present)
        if n <= width:
            phys[:n] = [pages[j] for j in present]
            logical[:n] = present
            return phys, logical
        recent = min(self.recent, width)
        n_cold = width - recent
        cold_logical = present[:n - recent]    # table idx of cold residents
        if scores is None:                     # no signal: keep newest pages
            keep_cold = cold_logical[len(cold_logical) - n_cold:]
        else:
            s = np.asarray([float(scores[pages[j]]) for j in cold_logical])
            # stable top-k by DLZS page score, ties to the newest pages
            order = np.argsort(-s, kind="stable")[:n_cold]
            keep_cold = np.sort(cold_logical[order])
        keep = np.concatenate([keep_cold, present[n - recent:]])
        phys[:len(keep)] = [pages[j] for j in keep]
        logical[:len(keep)] = keep
        return phys, logical

    def select_hot_sphere(self, pages: Sequence[int], width: int,
                          scores: Optional[np.ndarray] = None, *,
                          radius: Optional[float] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Sphere-rule hot selection with this allocator's recency window
        (see module-level ``select_hot_sphere``)."""
        return select_hot_sphere(pages, width, scores,
                                 recent=self.recent, radius=radius)
