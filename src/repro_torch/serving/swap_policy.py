"""Shared-prefix-aware swap core, shared by the paged and spatial engines.

Both engines preempt the same way — partition the victim's block table
into shared pages that stay live on the device (another sequence still
references them) and uniquely-owned pages that gather to the host
``SwapArea``; on page-in, retry the prefix index before allocating fresh
pages, rolling the whole plan back if the pool cannot supply it. That
core used to live as two drifting copies inside ``serving/paged.py`` and
``spatial/engine.py``; this module is the single implementation, with the
engine-specific parts (which pool owns page ``j``, how device rows are
gathered) injected as callables.

It also hosts the *lazy* swap primitives (``shed_candidates``,
``merge_shed``): under pressure a victim can park only its DLZS-cold
ref-1 pages — exactly the pages the hot-page decode gather was skipping
anyway — and keep decoding on its hot set. A shed table entry becomes the
``SHED`` sentinel; a later full preemption folds the shed payload into
the ordinary swap payload so resume sees one uniform format.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.kvcache.pool import PoolExhausted

SHED = -1   # block-table sentinel: page content parked on the host by a
#             lazy cold-page swap (the physical page was released)


@dataclasses.dataclass
class PrefillProgress:
    """Host-side cursor of a partially prefilled prompt (one shared shape
    for both engines — it is part of the swap payload)."""
    prompt: np.ndarray           # effective prompt (original + replayed)
    toks: Optional[tuple]        # same tokens as int tuple — built once,
    #                              reused for every chunk's prefix-index
    #                              key; None when prefix sharing is off
    spans: list                  # bucketing.chunk_spans output
    chunk: int                   # next span index to run
    sharing: bool                # prefix-share state carried across chunks
    suppress_first: bool         # recompute resume: the final chunk's
    #                              sampled token was already emitted
    pending: Optional[tuple] = None
    # (pages, fresh_globals, n_chunks) allocated for the next n_chunks
    # merged chunks by a batched-prefill attempt that has not computed
    # yet — kept OUT of the block table so a preemption (or a retried
    # batch) can release/reuse them cleanly. ``fresh_globals`` holds
    # GLOBAL logical page indices (engine_core normalizes every backend
    # to this addressing).


def release_pending(pf: Optional[PrefillProgress],
                    release: Callable[[list], None]) -> None:
    """Undo a not-yet-computed chunk allocation before parking/eviction."""
    if pf is not None and pf.pending is not None:
        release(pf.pending[0])
        pf.pending = None


def partition_table(table: Sequence[int], ref_of: Callable[[int], int]
                    ) -> tuple[list, list, list]:
    """Split a block table for parking.

    Returns (kept, park, shed): ``kept`` [(j, pid)] shared pages (ref > 1)
    that keep this sequence's reference on the device; ``park`` [j]
    uniquely-owned resident pages whose contents must gather to the host;
    ``shed`` [j] entries a lazy swap already parked (sentinel in the
    table). ``ref_of(j)`` resolves the refcount on page ``j``'s owner
    pool.
    """
    kept, park, shed = [], [], []
    for j, pid in enumerate(table):
        if pid < 0:
            shed.append(j)
        elif ref_of(j) > 1:
            kept.append((j, pid))
        else:
            park.append(j)
    return kept, park, shed


def progress_state(req, pf: Optional[PrefillProgress], *, share: bool,
                   length: int = 0, last_token: int = 0,
                   budget: int = 0) -> dict:
    """The engine-agnostic half of a swap payload: sequence progress plus
    the token key the page-in prefix re-lookup uses (mid-prefill: the
    effective prompt; in decode, conservatively the original prompt — its
    pages are the ones same-prefix traffic shares)."""
    toks = pf.toks if pf is not None else (
        tuple(int(x) for x in req.prompt) if share else None)
    state = {"lookup_toks": toks}
    if pf is not None:
        state.update(kind="prefill", prompt=pf.prompt, toks=pf.toks,
                     spans=pf.spans, chunk=pf.chunk, sharing=pf.sharing,
                     suppress_first=pf.suppress_first)
    else:
        state.update(kind="decode", length=length, last_token=last_token,
                     budget=budget)
    return state


def restore_progress(state: dict) -> Optional[PrefillProgress]:
    """Rebuild the prefill cursor from a swap payload (None: the sequence
    was preempted mid-decode — the caller restores decode fields)."""
    if state["kind"] != "prefill":
        return None
    return PrefillProgress(
        prompt=state["prompt"], toks=state["toks"], spans=state["spans"],
        chunk=state["chunk"], sharing=state["sharing"],
        suppress_first=state["suppress_first"])


def plan_page_in(park: Sequence[int], toks: Optional[tuple],
                 page_size: int,
                 lookup: Callable[[int, tuple], Optional[int]],
                 extend: Callable[[int], int],
                 rollback: Callable[[int, int], None]
                 ) -> Optional[tuple[dict, list]]:
    """Prefix-re-lookup page-in plan with rollback.

    For each parked table index ``j`` (payload order): a FULL prompt page
    first retries the prefix index (``lookup`` — a hit revives pooled
    content with zero upload, often the victim's own cached copy); misses
    allocate via ``extend``. Returns ``(filled {j: pid},
    upload [(park position, pid)])`` — only ``upload`` positions need
    their host rows written back. On PoolExhausted every page taken so
    far is rolled back through ``rollback(j, pid)`` and None is returned;
    the swap entry stays put and the caller retries next tick.
    """
    filled: dict[int, int] = {}
    upload: list[tuple[int, int]] = []
    taken: list[tuple[int, int]] = []
    try:
        for pos, j in enumerate(park):
            hit = None
            end = (j + 1) * page_size
            if toks is not None and end <= len(toks):
                hit = lookup(j, tuple(toks[:end]))
            if hit is None:
                hit = extend(j)
                upload.append((pos, hit))
            filled[j] = hit
            taken.append((j, hit))
    except PoolExhausted:
        for j, pid in taken:
            rollback(j, pid)
        return None
    return filled, upload


# ---------------------------------------------------------------------------
# Bounded fault retry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryGovernor:
    """Counted, backoff-governed retry policy for per-request faults.

    The engine's recompute fallback (drop pages, replay prompt + emitted
    tokens through prefill) can recover from any per-request failure —
    but unbounded it turns a persistent fault into an infinite retry
    loop. The governor counts faults per request id: each fault within
    ``max_retries`` grants another recompute attempt after a linearly
    growing delay (``backoff_ticks * attempt`` scheduler ticks — a
    transient fault clears while the request waits, a correlated one
    stops thrashing the pool); past the budget the request is
    quarantined into the FAILED terminal state. A request that finishes
    normally has its count forgotten, so a long-lived server does not
    slowly exhaust every rid's budget.
    """

    max_retries: int = 2
    backoff_ticks: int = 1
    counts: dict = dataclasses.field(default_factory=dict)

    def record_fault(self, rid: int) -> Optional[int]:
        """Count one fault against ``rid``. Returns the retry delay in
        ticks, or None when the budget is exhausted (quarantine)."""
        n = self.counts.get(rid, 0) + 1
        self.counts[rid] = n
        if n > self.max_retries:
            return None
        return self.backoff_ticks * n

    def attempts(self, rid: int) -> int:
        return self.counts.get(rid, 0)

    def forget(self, rid: int) -> None:
        self.counts.pop(rid, None)


# ---------------------------------------------------------------------------
# Lazy cold-page swap
# ---------------------------------------------------------------------------

def shed_candidates(table: Sequence[int], hot_logical: Sequence[int],
                    length: int, page_size: int,
                    ref_of: Callable[[int], int], *,
                    keep_recent: int) -> list[int]:
    """Table indices a lazy swap may park: resident, uniquely owned
    (shared pages free nothing), strictly full pages outside both the
    ``keep_recent`` newest-page window (the local attention window + the
    write page) and the current DLZS hot selection ``hot_logical`` — so
    the victim's hot-set decode output is unchanged by the shed; only
    pages the gather was already skipping leave the device."""
    hot = {int(j) for j in hot_logical if j >= 0}
    tail = length // page_size
    limit = min(len(table), tail + 1 - max(1, keep_recent))
    return [j for j in range(max(0, limit))
            if table[j] >= 0 and j not in hot and ref_of(j) == 1]


def merge_shed(state: dict, shed_state: Optional[dict],
               concat_rows: Callable[[object, object], object]) -> dict:
    """Fold a prior lazy-shed payload into a full swap payload so resume
    sees one uniform (rows, park) pair. ``concat_rows(a, b)`` joins two
    host row trees along their page axis (engine-specific layout); park
    order is preserved — resident-parked pages first, then the pages the
    earlier shed already held."""
    if shed_state is None:
        return state
    if state["rows"] is None:
        rows = shed_state["rows"]
    else:
        rows = concat_rows(state["rows"], shed_state["rows"])
    return dict(state, rows=rows,
                park=list(state["park"]) + list(shed_state["park"]))
