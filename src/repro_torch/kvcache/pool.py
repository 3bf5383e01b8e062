"""Global KV page pool: ref-counted pages, prefix index, copy-on-write.

``PagePool`` is pure host-side bookkeeping over a fixed set of page ids; the
device-side page arrays (one ``[n_pages, page_size, n_kv, head_dim]`` slab
per layer) are owned by the serving engine and indexed by these ids. Page 0
is reserved as a scratch page — inactive batch slots park their decode
writes there and over-length prefill scatters spill into it — so a pool of
capacity ``n_pages`` exposes ``n_pages - 1`` usable pages.

Lifecycle of a page:

    free ──alloc──> live (ref >= 1) ──decref to 0──┬──> cached   (in the
         <─────────────────────────────────────────┤    prefix index; content
         <──evict── cached                         └──> free     retained)

Prefix sharing: a *full* page of prompt tokens is keyed by the entire token
prefix up to its end (position-exact, so RoPE'd K/V match). ``lookup`` bumps
the refcount of a hit — identical prompt prefixes are stored once. Only full
pages enter the index: the partial tail page of a sequence is always
privately owned, so steady-state decode never writes a shared page. The
``cow`` path exists for the remaining case (an exactly page-aligned prompt
whose tail full-page is shared) and for external callers that mutate pages.

``SwapArea`` (bottom of this module) is the pool's host-side counterpart
for preemption: page contents of swapped-out sequences live there, keyed by
request id, until the scheduler pages them back in.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

SCRATCH = 0  # reserved page id: write target for inactive slots / padding

PrefixKey = tuple  # tuple of token ids up to (and including) a full page


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — caller must defer admission."""


@dataclasses.dataclass
class PoolStats:
    capacity: int            # usable pages (excludes the scratch page)
    free: int
    live: int                # pages with ref >= 1
    cached: int              # ref == 0 but retained for prefix reuse
    peak_live: int           # high-water mark of live pages
    shared_hits: int         # prefix-index hits (pages NOT duplicated)
    cow_copies: int
    evictions: int


@dataclasses.dataclass
class QuantStats:
    quantized: int           # pages currently flagged int8
    quantize_events: int     # cumulative fp -> int8 transitions


class QuantTracker:
    """Host bookkeeping for the int8 cold-page KV tier.

    Device truth lives in the per-layer ``kq``/``vq`` slabs and per-page
    scales; this tracker records WHICH page ids currently hold a valid
    quantized copy, so the backend can (a) skip re-quantizing, (b) build
    the per-step ``qmask`` the decode gather dequantizes through, and
    (c) account effective capacity honestly. Lifecycle mirrors the pool:
    a page's flag clears on ``alloc`` (fresh content is fp until it
    leaves the DLZS hot set again) and a COW destination inherits its
    source's flag (the page copy clones the int8 slab rows too).
    """

    def __init__(self, n_pages: int):
        self._flags = bytearray(n_pages)
        self._events = 0

    def on_alloc(self, pid: int) -> None:
        self._flags[pid] = 0

    def inherit(self, src: int, dst: int) -> None:
        self._flags[dst] = self._flags[src]

    def mark(self, pid: int) -> None:
        if not self._flags[pid]:
            self._flags[pid] = 1
            self._events += 1

    def is_quant(self, pid: int) -> bool:
        return pid >= 0 and bool(self._flags[pid])

    def count(self) -> int:
        return sum(self._flags)

    def stats(self) -> QuantStats:
        return QuantStats(quantized=self.count(),
                          quantize_events=self._events)


class PagePool:
    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.quant = QuantTracker(n_pages)
        self._ref = [0] * n_pages
        self._free: deque[int] = deque(range(1, n_pages))
        self._prefix: dict[PrefixKey, int] = {}
        self._key_of: dict[int, PrefixKey] = {}
        self._cached: set[int] = set()
        self._shared_hits = 0
        self._cow_copies = 0
        self._evictions = 0
        self._peak_live = 0

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> int:
        """Take a page off the free list with ref = 1."""
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted: {self.n_pages - 1} pages all live/cached")
        pid = self._free.popleft()
        self._ref[pid] = 1
        self.quant.on_alloc(pid)
        self._note_live()
        return pid

    def incref(self, pid: int) -> None:
        assert self._ref[pid] >= 1, f"incref on non-live page {pid}"
        self._ref[pid] += 1

    def decref(self, pid: int) -> None:
        """Release one reference; a ref-0 page is cached if indexed, else
        freed."""
        assert self._ref[pid] >= 1, f"decref on non-live page {pid}"
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            if pid in self._key_of:
                self._cached.add(pid)
            else:
                self._free.append(pid)

    def ref(self, pid: int) -> int:
        return self._ref[pid]

    # -- prefix sharing -----------------------------------------------------

    def lookup(self, key: PrefixKey) -> Optional[int]:
        """Return (and take a reference on) the page caching ``key``."""
        pid = self._prefix.get(key)
        if pid is None:
            return None
        if pid in self._cached:          # revive a cached page
            self._cached.discard(pid)
            self._ref[pid] = 1
            self._note_live()
        else:
            self._ref[pid] += 1
        self._shared_hits += 1
        return pid

    def register(self, key: PrefixKey, pid: int) -> None:
        """Index a live, fully-written page under its token-prefix key."""
        assert self._ref[pid] >= 1, "register requires a live page"
        if key in self._prefix:          # racing identical admits: keep first
            return
        self._prefix[key] = pid
        self._key_of[pid] = key

    def cow(self, pid: int) -> int:
        """Copy-on-write: detach one reference of a shared page onto a fresh
        page id. Caller must copy device content ``pid -> returned id``."""
        assert self._ref[pid] >= 2, "cow only applies to shared pages"
        new = self.alloc()
        self._ref[pid] -= 1
        self._cow_copies += 1
        self.quant.inherit(pid, new)   # the page copy clones int8 rows too
        return new

    def forget(self, pid: int) -> None:
        """Drop a page's prefix-index entry (no-op when unindexed).

        The fault-recovery path for a registered-but-never-written page:
        a batched prefill registers fresh full-prompt pages BEFORE its
        wave dispatch scatters their content (same-tick dedup), so a
        dispatch failure would otherwise leave garbage pages revivable
        through the index. Only the exact ``key -> pid`` mapping is
        removed — a racing re-registration of the same key by another
        page is left alone. A cached (ref-0) page returns to the free
        list immediately; a live page just loses cacheability.
        """
        key = self._key_of.pop(pid, None)
        if key is not None and self._prefix.get(key) == pid:
            del self._prefix[key]
        if pid in self._cached:
            self._cached.discard(pid)
            self._free.append(pid)

    # -- eviction -----------------------------------------------------------

    def evictable(self) -> list[int]:
        """Cached (ref-0) pages, in no particular order."""
        return list(self._cached)

    def evict(self, pid: int) -> None:
        """Drop a cached page from the prefix index back to the free list."""
        assert pid in self._cached, f"page {pid} is not evictable"
        self._cached.discard(pid)
        key = self._key_of.pop(pid)
        self._prefix.pop(key, None)
        self._free.append(pid)
        self._evictions += 1

    # -- stats --------------------------------------------------------------

    def _note_live(self) -> None:
        self._peak_live = max(self._peak_live, self.live_pages())

    def live_pages(self) -> int:
        return sum(1 for r in self._ref if r > 0)

    def free_pages(self) -> int:
        return len(self._free)

    def stats(self) -> PoolStats:
        return PoolStats(
            capacity=self.n_pages - 1, free=len(self._free),
            live=self.live_pages(), cached=len(self._cached),
            peak_live=self._peak_live, shared_hits=self._shared_hits,
            cow_copies=self._cow_copies, evictions=self._evictions)


# ---------------------------------------------------------------------------
# Host-side swap area (preemption under pool pressure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SwapStats:
    entries: int             # sequences currently parked on the host
    bytes: int               # host bytes currently held
    peak_bytes: int
    swap_outs: int
    swap_ins: int


class SwapArea:
    """Host-side parking lot for preempted sequences' page contents.

    The pool is device-side and fixed-size; under pressure the scheduler
    preempts a low-priority sequence and parks its pages *here* (plain host
    arrays, engine-opaque payloads) instead of rejecting new work. The
    entry key is the request id; swap-in pops the payload, and the engine
    re-allocates device pages and uploads the content. ``SwapArea`` is pure
    bookkeeping — it never touches device memory itself, mirroring how
    ``PagePool`` never touches the slabs.
    """

    def __init__(self) -> None:
        self._entries: dict[int, tuple[object, int]] = {}
        self._bytes = 0
        self._peak_bytes = 0
        self._swap_outs = 0
        self._swap_ins = 0

    def put(self, rid: int, payload: object, nbytes: int) -> None:
        assert rid not in self._entries, f"request {rid} already swapped"
        self._entries[rid] = (payload, nbytes)
        self._bytes += nbytes
        self._peak_bytes = max(self._peak_bytes, self._bytes)
        self._swap_outs += 1

    def peek(self, rid: int) -> object:
        """Payload without removing it — lets the engine size up a page-in
        before committing to it."""
        return self._entries[rid][0]

    def take(self, rid: int) -> object:
        payload, nbytes = self._entries.pop(rid)
        self._bytes -= nbytes
        self._swap_ins += 1
        return payload

    def discard(self, rid: int) -> object:
        """Drop an entry WITHOUT counting a swap-in: lazy-shed payloads
        being merged into a full swap payload, or a finished sequence
        whose shed pages are simply no longer needed. Returns the payload
        (None when no entry exists)."""
        if rid not in self._entries:
            return None
        payload, nbytes = self._entries.pop(rid)
        self._bytes -= nbytes
        return payload

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def items(self) -> list[tuple[int, object]]:
        """(rid, payload) pairs for every parked entry — the accounting
        walk; payloads stay owned by the area."""
        return [(rid, payload) for rid, (payload, _) in
                self._entries.items()]

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> SwapStats:
        return SwapStats(entries=len(self._entries), bytes=self._bytes,
                         peak_bytes=self._peak_bytes,
                         swap_outs=self._swap_outs, swap_ins=self._swap_ins)
