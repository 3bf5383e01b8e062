"""Admission / chunked-prefill / preemption policy for the paged engine.

The scheduler decides WHAT happens each engine step; the engine decides HOW
(device work, page tables, device kernels). One ``tick`` interleaves three
phases against an executor (``PagedServingEngine`` implements the protocol):

  1. resume/admit — swap preempted sequences back in (highest priority
     first; a blocked swap-in holds the line so large sequences cannot
     starve), then bind waiting requests to free slots. Admission binds a
     SLOT only — pages are allocated chunk-by-chunk during prefill, so a
     long prompt no longer reserves its worst case up front.
  2. prefill — advance at most ``prefill_per_step`` prefilling sequences by
     ONE page-aligned chunk each, shortest-remaining-first within a
     priority level, with aging: a prefill passed over ``starvation_ticks``
     times jumps the SJF queue, so a long prompt keeps progressing under a
     sustained short-prompt stream. Decode never waits for a whole prompt:
     a long prefill is sliced across many ticks and short requests
     admitted mid-way reach their first token early (chunked prefill is
     what bounds TTFT).
  3. decode — one fused decode step over every decode-phase slot.

Pool pressure: when a chunk allocation or decode-time page growth hits
``PoolExhausted``, the executor raises ``NeedPages`` and the scheduler
preempts a victim — the lowest-priority page-holding sequence whose
priority does not exceed the needy one's, newest first, preferring
sequences not resumed this tick (anti-thrash; a resumed one is still
evicted when it is the only eligible victim) — then retries. Preemption either
SWAPS the victim's pages to the host ``SwapArea`` (cfg.swap=True; resumed
by a page-in) or RELEASES them for recompute-from-prompt (the generated
tokens are replayed through a chunked prefill on re-admission; greedy
decode makes the replay exact). Either way the victim re-enters the queue
ahead of later arrivals, so overload degrades throughput — it never rejects
requests. A sequence that must grow but is itself the lowest-priority
runner preempts itself; because ``submit`` caps any single request at pool
capacity, the highest-priority sequence can always make progress, which is
the no-deadlock argument the pressure tests pin down.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Protocol, Union

from repro_torch.kvcache.bucketing import pack_budget
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serving.engine import Request
from repro_torch.serving.swap_policy import RetryGovernor


class NeedPages(RuntimeError):
    """Executor signal: ``slot`` needs pool pages it could not obtain.

    Raised instead of ``PoolExhausted`` once a request is running, so the
    scheduler can pick a preemption victim and retry rather than defer.
    ``shard`` (optional) names the starved pool for engines that run one
    pool per device shard — victim selection then requires a victim that
    actually frees pages THERE, not just somewhere."""

    def __init__(self, slot: int, shard: Optional[int] = None):
        where = "" if shard is None else f" on shard {shard}"
        super().__init__(f"slot {slot} needs pages{where}")
        self.slot = slot
        self.shard = shard


class ExecFault(RuntimeError):
    """Executor signal: an exec_* call failed on a per-request basis.

    Raised by the engine when a backend seam throws something that is
    NOT pool pressure (``NeedPages``) — a dispatch exception, a swap
    payload that would not upload. Engine state has already been rolled
    back to a consistent point; the scheduler decides what happens to
    the blamed requests: bounded retry-with-recompute (the existing
    recompute fallback, governed by ``swap_policy.RetryGovernor``) or
    quarantine into the FAILED terminal state via ``exec_abort``. The
    whole engine never unwinds for a per-request fault.

    ``slots`` are the running slots the fault is attributed to (a fused
    decode blames every decode slot — recompute replay is exact under
    greedy decode, so innocents still finish correctly). ``rid`` is set
    instead when the victim was not running (a failed swap-in).
    """

    def __init__(self, slots, cause: BaseException, where: str,
                 rid: Optional[int] = None):
        super().__init__(f"executor fault in {where}: {cause!r}")
        self.slots = list(slots)
        self.cause = cause
        self.where = where
        self.rid = rid


# SLA classes: the external QoS input mapped onto Request.priority.
# Higher priority = admitted first, preempted last; the numeric gaps leave
# room for finer-grained levels without renumbering.
SLA_PRIORITY = {"batch": -10, "standard": 0, "interactive": 10}

# Default (ttft_ms, e2e_ms) deadline budgets per SLA class, applied at
# submit when ``SchedulerCfg.sla_deadlines`` is on and the request did not
# pin its own. Batch traffic is deliberately unbounded — it is the tier
# admission shedding sacrifices instead.
SLA_DEADLINES_MS = {"interactive": (1_000.0, 10_000.0),
                    "standard": (5_000.0, 30_000.0),
                    "batch": (None, None)}


def sla_priority(sla: str) -> int:
    try:
        return SLA_PRIORITY[sla]
    except KeyError:
        raise ValueError(
            f"unknown SLA class {sla!r}: choose from "
            f"{sorted(SLA_PRIORITY)}") from None


@dataclasses.dataclass(frozen=True)
class AdmissionCfg:
    """SLA-aware admission shedding with hysteresis.

    When the waiting backlog crosses ``high_watermark`` the scheduler
    starts rejecting fresh best-effort arrivals (priority strictly below
    ``shed_below_priority`` — the SLA map puts "batch" at -10, so the
    default sheds batch but never standard/interactive) until the
    backlog falls to ``low_watermark``. Hysteresis keeps the decision
    stable: one threshold would flap on/off every tick at the boundary.
    Only never-started fresh requests are shed — preempted or swapped
    work already holds progress and always re-enters.
    """
    high_watermark: int = 8
    low_watermark: int = 2
    shed_below_priority: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulerCfg:
    chunk_pages: Optional[int] = 4   # prefill chunk size in pages
    #                                  (None = monolithic, the pre-chunking
    #                                  behavior: one prefill per prompt)
    prefill_tokens: Optional[Union[int, str]] = None
    # Per-tick prefill TOKEN budget: each tick packs the next chunk of as
    # many prefilling sequences as fit (padded widths, SJF+aging order)
    # and advances them all in ONE batched varlen dispatch
    # (``exec_prefill_chunk_batch``). This replaces the per-SEQUENCE
    # ``prefill_per_step`` counter as the throughput knob — one dispatch
    # per tick regardless of how many prompts are mid-prefill, which is
    # what closes the chunked-vs-monolithic gap. None (or monolithic
    # chunk_pages=None) keeps the legacy one-dispatch-per-sequence path.
    # "auto" (the ``api.LLM`` default) sizes the dispatch buffer to
    # AUTO_PREFILL_CHUNKS chunks and lets a ``BudgetController`` grow/
    # shrink the per-tick PACKING budget inside that fixed buffer from
    # observed tick wall-times (compile-safe: the compiled width never
    # changes, only how much of it a tick fills).
    autotune_target_s: float = 0.5   # "auto" only: EMA controller keeps
    #                                  one prefill phase near this wall
    #                                  time — bounds how long co-resident
    #                                  decodes stall behind prefill
    prefill_per_step: int = 1        # LEGACY path only: prefill chunks
    #                                  advanced per tick when no token
    #                                  budget is set
    swap: bool = True                # preempt via host swap (False: drop
    #                                  pages, recompute from prompt+output)
    lazy_swap: bool = False          # under pressure, first try shedding a
    #                                  victim's DLZS-cold ref-1 pages to the
    #                                  SwapArea (``exec_shed_cold``) so it
    #                                  keeps decoding on its hot set; full
    #                                  preemption only when nobody can shed
    starvation_ticks: int = 8        # a prefill passed over this many
    #                                  ticks goes first regardless of
    #                                  remaining length (anti-starvation
    #                                  aging for long prompts under a
    #                                  sustained short-prompt stream)
    decode_hot_width: Optional[int] = None
    # Bounded decode sparsity: cap the per-sequence decode gather at this
    # many pages, selected by the SADS sphere rule over per-page DLZS
    # scores (kvcache.allocator.select_hot_sphere). None (default) keeps
    # the engine's full ``hot_pages`` recency+top-k policy — bit-identical
    # to the pre-sparsity decode. The effective width is
    # ``min(hot_pages, decode_hot_width)`` (per shard on the spatial
    # engine), fixed at engine construction so decode still compiles once.
    decode_hot_radius: Optional[float] = 4.0
    # Sphere radius in DLZS score units (max |int8 LZ code| per page): a
    # cold page is a hot-set candidate only when its score is within this
    # distance of the best page's. None disables the admission test
    # (pure bounded top-k). Only read when decode_hot_width is set.
    kv_quant: Optional[str] = None   # int8 cold KV tier: pages leaving
    #                                  the DLZS hot set quantize to int8
    #                                  with per-page scales
    #                                  (kvcache.quant); decode dequantizes
    #                                  on gather. None = fp-only slabs
    #                                  (bit-identical dense default);
    #                                  "int8" enables the tier.
    fault_retries: int = 2           # per-request fault budget: recompute
    #                                  retries granted before quarantine
    #                                  into the FAILED terminal state
    fault_backoff_ticks: int = 1     # retry delay grows linearly with the
    #                                  attempt number, in scheduler ticks
    admission: Optional[AdmissionCfg] = None
    # overload shedding policy; None (default) admits everything — the
    # pre-robustness behavior (overload degrades, never rejects)
    sla_deadlines: bool = False      # apply SLA_DEADLINES_MS defaults at
    #                                  submit to requests that did not pin
    #                                  their own deadline budgets


@dataclasses.dataclass
class SchedStats:
    preemptions: int = 0
    swap_outs: int = 0
    recomputes: int = 0
    resumes: int = 0
    sheds: int = 0                   # lazy cold-page swaps (victim kept
    #                                  running; not counted as preemptions)
    faults: int = 0                  # per-request executor faults isolated
    fault_retries: int = 0           # faults answered with a recompute retry
    quarantines: int = 0             # faults that exhausted the retry
    #                                  budget (FAILED terminal state)
    admission_sheds: int = 0         # fresh best-effort arrivals rejected
    #                                  by overload admission control


AUTO_PREFILL_CHUNKS = 6   # "auto": the compiled dispatch buffer holds up
#                           to this many chunks; the controller moves the
#                           packing budget inside it. A wider buffer buys
#                           deeper packing but pays its padding compute
#                           every dispatch — 6 chunks is the measured
#                           knee on the mixed workload
#                           (BENCH_serving.json batched_prefill)


def resolve_prefill_tokens(cfg: SchedulerCfg, page_size: int
                           ) -> Optional[int]:
    """The numeric flat-buffer width a ``prefill_tokens`` setting implies
    (what the engine compiles once). ``"auto"`` sizes the buffer to
    ``AUTO_PREFILL_CHUNKS`` chunks — the controller's upper bound."""
    pt = cfg.prefill_tokens
    if pt is None or cfg.chunk_pages is None:
        return None
    if pt == "auto":
        return AUTO_PREFILL_CHUNKS * cfg.chunk_pages * page_size
    return int(pt)


class BudgetController:
    """EMA autotuner for the per-tick prefill token budget.

    The dispatch buffer compiles ONCE at ``hi`` tokens; this controller
    only moves how many tokens a tick may PACK into it — always a
    multiple of ``quantum`` (page-aligned, so span math never changes)
    inside ``[lo, hi]``, which is what keeps autotuning compile-safe.
    Each observed prefill phase updates an EMA of seconds-per-packed-
    token; the budget is then set so one phase lands near ``target_s``:
    fast hardware drifts to ``hi`` (throughput), slow or contended
    hardware shrinks toward ``lo`` so co-resident decodes are not
    starved behind a fat prefill dispatch.
    """

    def __init__(self, lo: int, hi: int, quantum: int,
                 target_s: float = 0.5, alpha: float = 0.4):
        assert 0 < lo <= hi and quantum > 0 and target_s > 0
        self.lo, self.hi, self.quantum = lo, hi, quantum
        self.target_s = target_s
        self.alpha = alpha
        self._per_tok: Optional[float] = None
        self.budget = hi             # optimistic start: shrink on evidence

    def observe(self, wall_s: float, packed_tokens: int) -> None:
        """Feed one prefill phase's wall time and packed token count."""
        if packed_tokens <= 0 or wall_s <= 0:
            return
        per = wall_s / packed_tokens
        self._per_tok = per if self._per_tok is None else \
            (1 - self.alpha) * self._per_tok + self.alpha * per
        want = int(self.target_s / self._per_tok)
        want = (want // self.quantum) * self.quantum
        self.budget = max(self.lo, min(self.hi, want))


class Executor(Protocol):
    """What the scheduler needs from an engine (or a test fake)."""

    def free_slot_available(self) -> bool: ...

    def exec_admit(self, req: Request) -> int:
        """Bind a request (fresh, or recompute-resume carrying prior
        output) to a free slot. Allocates NO pages."""

    def exec_prefill_chunk(self, slot: int) -> bool:
        """Advance one chunk; True when the prompt is fully prefilled and
        the slot entered decode. May raise NeedPages."""

    def exec_prefill_chunk_batch(self, batch: list[tuple[int, int]]
                                 ) -> list[int]:
        """Advance every ``(slot, n_chunks)`` entry by n CONSECUTIVE
        chunks in a single batched varlen dispatch; returns the slots
        whose prompt completed (they entered decode). May raise
        NeedPages(slot) from the allocation stage — in that case NO slot
        advanced (allocations already made for other slots are kept and
        reused on retry), so the scheduler preempts/sheds and calls
        again."""

    def pending_chunk_widths(self, slot: int) -> list[int]:
        """Padded token widths of the slot's remaining prefill chunks,
        next first (what they cost against the per-tick token budget)."""

    def prefill_chunks_left(self, slot: int) -> int: ...

    def exec_shed_cold(self, slot: int, shard: Optional[int] = None
                       ) -> int:
        """Lazy swap: park the slot's DLZS-cold uniquely-owned pages in
        the SwapArea WITHOUT stopping it — the sequence keeps decoding
        on its hot set. Returns the number of pages freed (0 when the
        slot has nothing sheddable, e.g. mid-prefill or all pages hot).
        Only called when ``SchedulerCfg.lazy_swap`` is set."""

    def held_pages(self, slot: int, shard: Optional[int] = None) -> int:
        """Pool pages preempting the slot would actually free (the
        engine counts uniquely-owned pages; shared ones survive).
        ``shard`` restricts the count to one pool shard — single-pool
        engines ignore it."""

    def exec_decode(self) -> list[tuple[int, "Request"]]:
        """One fused decode step; returns finished (slot, request) pairs.
        May raise NeedPages (a sequence's tail page filled up)."""

    def exec_preempt(self, slot: int, swap: bool) -> bool:
        """Evict a running sequence. True if its state went to the swap
        area (resume = page-in), False if dropped for recompute."""

    def exec_swap_in(self, req: Request) -> Optional[int]:
        """Restore a swapped sequence into a free slot; None when the pool
        cannot hold its pages right now (caller retries next tick). May
        raise ExecFault (payload would not restore — the engine already
        dropped its pages; the scheduler falls back to recompute)."""

    def exec_abort(self, req: Request, outcome: str, reason: str) -> None:
        """Move a NON-running request to a terminal state (``outcome`` is
        "failed" for a quarantine, "cancelled" for an admission shed).
        The engine discards any parked swap payload and surfaces the
        request through its finished stream."""


@dataclasses.dataclass
class _Waiting:
    req: Request
    seqno: int                  # admission-order tiebreak (stable across
    #                             preemption, so resumed work keeps rank)
    swapped: bool = False       # payload parked in the engine's SwapArea
    not_before: int = 0         # fault backoff: earliest tick this item
    #                             may be admitted again

    @property
    def key(self):
        return (-self.req.priority, self.seqno)


@dataclasses.dataclass
class _Running:
    req: Request
    seqno: int
    phase: str                  # "prefill" | "decode"


class Scheduler:
    def __init__(self, cfg: SchedulerCfg = SchedulerCfg()):
        self.cfg = cfg
        self.waiting: list[_Waiting] = []
        self.running: dict[int, _Running] = {}     # slot -> state
        self.stats = SchedStats()
        self._seqno = 0
        self._tick = 0
        self._resumed_tick: set[int] = set()
        self._pf_wait: dict[int, int] = {}   # prefill slot -> ticks since
        #                                      its last chunk (aging)
        self._retry = RetryGovernor(max_retries=cfg.fault_retries,
                                    backoff_ticks=cfg.fault_backoff_ticks)
        self._shedding = False       # admission-control hysteresis state
        self.budget_ctl: Optional[BudgetController] = None
        self._budget_warm = False    # first batched phase pays one-time
        #                              warm-up: never feed it to the EMA
        self.tel = NULL_TELEMETRY    # shared via EngineCore.attach_telemetry
        if cfg.prefill_tokens == "auto":
            # placeholder bounds until the engine attaches real ones
            # (attach_budget) — an unattached "auto" packs greedily
            self.budget_ctl = BudgetController(
                lo=1, hi=1 << 30, quantum=1,
                target_s=cfg.autotune_target_s)

    def attach_budget(self, lo: int, hi: int, quantum: int) -> None:
        """Bind the ``"auto"`` budget controller to the engine's compiled
        dispatch bounds (called by EngineCore once the backend knows its
        flat-buffer width). No-op unless cfg.prefill_tokens == "auto"."""
        if self.cfg.prefill_tokens == "auto":
            self.budget_ctl = BudgetController(
                lo=lo, hi=hi, quantum=quantum,
                target_s=self.cfg.autotune_target_s)

    def prefill_budget(self) -> Optional[int]:
        """Tokens the next batched prefill phase may pack."""
        if self.budget_ctl is not None:
            return self.budget_ctl.budget
        return self.cfg.prefill_tokens

    # -- queue --------------------------------------------------------------

    def submit(self, req: Request, *, swapped: bool = False) -> None:
        # the QoS input: an SLA class maps onto the priority every policy
        # below ranks by — unless the caller pinned an explicit priority
        if getattr(req, "sla", None) is not None and req.priority == 0:
            req.priority = sla_priority(req.sla)
        # swapped=True: the caller already parked a payload for this rid
        # in the engine's SwapArea (a cross-instance transfer adopting a
        # request) — admission goes through exec_swap_in, not exec_admit
        self.waiting.append(_Waiting(req, self._seqno, swapped=swapped))
        self._seqno += 1

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def queued_requests(self) -> list[Request]:
        return [w.req for w in sorted(self.waiting, key=lambda w: w.key)]

    def drop_waiting(self, rid: int) -> Optional[Request]:
        """Remove a waiting request (cancellation/expiry); returns it, or
        None when no such rid waits. The caller owns any swap payload."""
        for w in self.waiting:
            if w.req.rid == rid:
                self.waiting.remove(w)
                self._retry.forget(rid)
                return w.req
        return None

    def drop_running_slot(self, slot: int) -> Optional[Request]:
        """Forget a running slot (the engine tears the slot itself down —
        cancellation/expiry path); returns its request, or None."""
        st = self.running.pop(slot, None)
        self._pf_wait.pop(slot, None)
        if st is None:
            return None
        self._retry.forget(st.req.rid)
        return st.req

    # -- one engine step ----------------------------------------------------

    def tick(self, ex: Executor) -> list[Request]:
        self._tick += 1
        self._resumed_tick.clear()
        if not self.tel.enabled:
            self._admit_phase(ex)
            self._prefill_phase(ex)
            return self._decode_phase(ex)
        tr = self.tel.tracer
        with tr.span("phase.admit"):
            self._admit_phase(ex)
        with tr.span("phase.prefill"):
            self._prefill_phase(ex)
        with tr.span("phase.decode"):
            return self._decode_phase(ex)

    # Phase 1: swapped sequences outrank fresh arrivals of equal priority
    # (smaller seqno); a swap-in that does not fit blocks lower-ranked
    # admissions so big preempted sequences cannot starve behind a stream
    # of small fresh ones.
    def _admit_phase(self, ex: Executor) -> None:
        if self.cfg.admission is not None:
            self._admission_control(ex)
        while ex.free_slot_available():
            ready = [w for w in self.waiting
                     if w.not_before <= self._tick]
            if not ready:
                return
            item = min(ready, key=lambda w: w.key)
            if item.swapped:
                try:
                    slot = ex.exec_swap_in(item.req)
                except ExecFault as e:
                    self._fault_waiting(ex, item, e)
                    continue
                if slot is None:
                    return                         # retry next tick
                # a swapped prefill resumes mid-chunk-sequence
                phase = self._swapped_phase(ex, slot)
                self.running[slot] = _Running(item.req, item.seqno, phase)
                self._resumed_tick.add(slot)
                self.stats.resumes += 1
            else:
                slot = ex.exec_admit(item.req)
                self.running[slot] = _Running(item.req, item.seqno,
                                              "prefill")
            self._pf_wait.pop(slot, None)      # slot reuse: fresh aging
            self.waiting.remove(item)

    @staticmethod
    def _swapped_phase(ex: Executor, slot: int) -> str:
        return "prefill" if ex.prefill_chunks_left(slot) > 0 else "decode"

    # -- overload admission control ------------------------------------------

    def _admission_control(self, ex: Executor) -> None:
        """Hysteresis-gated shedding of fresh best-effort arrivals: shed
        lowest-priority-newest-first until the backlog reaches the low
        watermark (or nothing eligible remains). Runs once per tick at
        admit start, so the watermark decision sees the full backlog."""
        acfg = self.cfg.admission
        backlog = len(self.waiting)
        if not self._shedding and backlog >= acfg.high_watermark:
            self._shedding = True
        elif self._shedding and backlog <= acfg.low_watermark:
            self._shedding = False
        if not self._shedding:
            return
        cands = sorted((w for w in self.waiting
                        if not w.swapped and not (w.req.out or ())
                        and w.req.priority < acfg.shed_below_priority),
                       key=lambda w: (w.req.priority, -w.seqno))
        for w in cands:
            if len(self.waiting) <= acfg.low_watermark:
                break
            self.waiting.remove(w)
            self.stats.admission_sheds += 1
            ex.exec_abort(w.req, "cancelled", "admission_shed")

    # -- per-request fault isolation -----------------------------------------

    def _fault_waiting(self, ex: Executor, item: _Waiting,
                       e: ExecFault) -> None:
        """A swap-in failed: the engine already dropped the payload and
        its pages, so the item either retries as a recompute (its request
        still carries prompt + emitted tokens) or quarantines."""
        self.stats.faults += 1
        rid = item.req.rid
        delay = self._retry.record_fault(rid)
        if delay is None:
            self.waiting.remove(item)
            self.stats.quarantines += 1
            ex.exec_abort(item.req, "failed",
                          f"{e.where}:{type(e.cause).__name__}")
            return
        item.swapped = False
        item.not_before = self._tick + delay
        self.stats.fault_retries += 1
        if self.tel.enabled:
            self.tel.recorder.record(
                "retry", rid=rid, where=e.where,
                attempt=self._retry.attempts(rid), delay=delay)

    def _fault_slots(self, ex: Executor, e: ExecFault) -> None:
        for slot in e.slots:
            self._fault_slot(ex, slot, e)

    def _fault_slot(self, ex: Executor, slot: int, e: ExecFault) -> None:
        """Quarantine-or-retry for a running slot: drop its pages (the
        recompute preemption path — NOT counted as a preemption) and
        requeue after a backoff, or abort once the budget is spent."""
        st = self.running.pop(slot, None)
        if st is None:
            return
        self._pf_wait.pop(slot, None)
        self.stats.faults += 1
        rid = st.req.rid
        delay = self._retry.record_fault(rid)
        ex.exec_preempt(slot, False)       # release pages for recompute
        if delay is None:
            self.stats.quarantines += 1
            ex.exec_abort(st.req, "failed",
                          f"{e.where}:{type(e.cause).__name__}")
            return
        self.stats.fault_retries += 1
        self.waiting.append(_Waiting(st.req, st.seqno, swapped=False,
                                     not_before=self._tick + delay))
        if self.tel.enabled:
            self.tel.recorder.record(
                "retry", rid=rid, slot=slot, where=e.where,
                attempt=self._retry.attempts(rid), delay=delay)

    # Phase 2: shortest-remaining-prefill-first within a priority level —
    # the chunk policy that minimizes short-request TTFT under mixed
    # traffic. SJF alone would starve a long prompt under a sustained
    # stream of short ones, so a prefill passed over ``starvation_ticks``
    # times is aged to the front of its priority level (oldest first).
    #
    # Two dispatch modes: with a ``prefill_tokens`` budget, ONE batched
    # varlen dispatch advances every sequence that packs under the budget
    # (the continuous-batching form); otherwise the legacy loop issues up
    # to ``prefill_per_step`` one-sequence dispatches.
    def _prefill_order_key(self, ex: Executor):
        def order(slot):
            st = self.running[slot]
            starved = self._pf_wait.get(slot, 0) >= \
                self.cfg.starvation_ticks
            return (-st.req.priority, not starved,
                    st.seqno if starved else ex.prefill_chunks_left(slot),
                    st.seqno)
        return order

    def _prefill_phase(self, ex: Executor) -> None:
        if self.cfg.prefill_tokens is not None \
                and self.cfg.chunk_pages is not None:
            advanced = self._prefill_batched(ex)
        else:
            advanced = self._prefill_sequential(ex)
        # aging bookkeeping: slots passed over this tick accumulate wait
        for s, st in list(self.running.items()):
            if st.phase == "prefill":
                self._pf_wait[s] = 0 if s in advanced \
                    else self._pf_wait.get(s, 0) + 1
            else:
                self._pf_wait.pop(s, None)

    def _prefill_sequential(self, ex: Executor) -> set[int]:
        order = self._prefill_order_key(ex)
        budget = self.cfg.prefill_per_step
        advanced: set[int] = set()
        while budget > 0:
            cands = sorted((s for s, st in self.running.items()
                            if st.phase == "prefill"), key=order)
            if not cands:
                break
            slot = cands[0]
            advanced.add(slot)
            budget -= 1
            try:
                if ex.exec_prefill_chunk(slot):
                    self.running[slot].phase = "decode"
            except ExecFault as e:
                self._fault_slots(ex, e)
                continue
            except NeedPages as e:
                if self._try_shed(ex, needy=slot, shard=e.shard):
                    budget += 1                    # retry the same slot
                    continue
                victim = self._pick_victim(ex, needy=slot, shard=e.shard)
                if victim is None or victim == slot:
                    self._preempt(ex, slot)        # self-preempt: requeue
                else:
                    self._preempt(ex, victim)
                    budget += 1                    # retry the same slot
        return advanced

    def _prefill_batched(self, ex: Executor) -> set[int]:
        """Pack next-chunks under the token budget (SJF + aging order)
        and advance them all in one dispatch. Pressure preempts/sheds and
        retries with a re-packed batch — the failed call advanced nobody,
        so the retry is clean."""
        order = self._prefill_order_key(ex)
        advanced: set[int] = set()
        t0 = time.perf_counter()
        packed_tokens = 0
        while True:
            cands = sorted((s for s, st in self.running.items()
                            if st.phase == "prefill"
                            and s not in advanced), key=order)
            if not cands:
                break
            widths = [(s, ex.pending_chunk_widths(s)) for s in cands]
            batch = pack_budget(widths, self.prefill_budget())
            try:
                done = ex.exec_prefill_chunk_batch(batch)
            except ExecFault as e:
                # the engine purged every pending cursor in the batch;
                # blamed slots retry-or-quarantine, the rest repack clean
                self._fault_slots(ex, e)
                continue
            except NeedPages as e:
                if self._try_shed(ex, needy=e.slot, shard=e.shard):
                    continue
                victim = self._pick_victim(ex, needy=e.slot,
                                           shard=e.shard)
                if victim is None or victim == e.slot:
                    self._preempt(ex, e.slot)
                else:
                    self._preempt(ex, victim)
                continue
            by_slot = dict(widths)
            packed_tokens += sum(sum(by_slot[s][:n]) for s, n in batch)
            advanced.update(s for s, _ in batch)
            for slot in done:
                self.running[slot].phase = "decode"
            break
        if self.budget_ctl is not None and packed_tokens:
            # the first dispatch's wall time is dominated by one-time
            # warm-up (library handles, allocator growth) — feeding it to
            # the EMA would collapse every cold start to the floor budget
            if self._budget_warm:
                before = self.budget_ctl.budget
                self.budget_ctl.observe(time.perf_counter() - t0,
                                        packed_tokens)
                if self.tel.enabled and self.budget_ctl.budget != before:
                    self.tel.tracer.instant(
                        "budget.update", tokens=self.budget_ctl.budget,
                        was=before)
                    self.tel.metrics.counter(
                        "engine_budget_updates_total",
                        "autotuner budget changes").inc()
            self._budget_warm = True
        if self.tel.enabled and packed_tokens:
            self.tel.metrics.counter(
                "engine_prefill_tokens_total",
                "tokens packed into batched prefill dispatches").inc(
                packed_tokens)
        return advanced

    # Phase 3: decode retries after preempting until the batch fits.
    def _decode_phase(self, ex: Executor) -> list[Request]:
        if not any(st.phase == "decode" for st in self.running.values()):
            return []
        while True:
            try:
                finished = ex.exec_decode()
                break
            except ExecFault as e:
                self._fault_slots(ex, e)
                if not any(st.phase == "decode"
                           for st in self.running.values()):
                    return []
                continue
            except NeedPages as e:
                if self._try_shed(ex, needy=e.slot, shard=e.shard):
                    continue
                victim = self._pick_victim(ex, needy=e.slot, shard=e.shard)
                if victim is None:
                    victim = e.slot
                self._preempt(ex, victim)
                if not any(st.phase == "decode"
                           for st in self.running.values()):
                    return []
        out = []
        for slot, req in finished:
            del self.running[slot]
            self._retry.forget(req.rid)    # a clean finish clears the
            #                                request's fault budget
            out.append(req)
        return out

    # -- preemption ---------------------------------------------------------

    def _victim_candidates(self, ex: Executor, needy: int,
                           shard: Optional[int]) -> list[int]:
        """Victim-rank-ordered slots eligible to relieve pressure for
        ``needy``: must actually free pages (on ``shard`` when given)
        and must not outrank the needy slot — shared by full preemption
        and lazy shedding so the two policies can never drift apart.
        Rank: lowest priority first; within a level prefer slots NOT
        resumed this tick (anti-thrash), then the newest."""
        def rank(slot):
            st = self.running[slot]
            return (st.req.priority, slot in self._resumed_tick, -st.seqno)

        needy_prio = self.running[needy].req.priority \
            if needy in self.running else 0
        return sorted((s for s in self.running
                       if ex.held_pages(s, shard) > 0
                       and self.running[s].req.priority <= needy_prio),
                      key=rank)

    def _try_shed(self, ex: Executor, needy: int,
                  shard: Optional[int] = None) -> bool:
        """Lazy pressure relief: before stopping anyone, ask candidates in
        victim-rank order to park their DLZS-cold uniquely-owned pages
        (``exec_shed_cold``) while they keep decoding on their hot set.
        True when some slot freed at least one page — the caller retries
        without a preemption. Same candidate filter as ``_pick_victim``,
        so shedding never touches higher-priority work either."""
        if not self.cfg.lazy_swap:
            return False
        for slot in self._victim_candidates(ex, needy, shard):
            if ex.exec_shed_cold(slot, shard) > 0:
                self.stats.sheds += 1
                return True
        return False

    def _pick_victim(self, ex: Executor, needy: int,
                     shard: Optional[int] = None) -> Optional[int]:
        """Among slots whose eviction actually FREES pages (preempting a
        page-less or all-shared-pages slot frees nothing — it only churns
        admissions; when the executor names a starved ``shard``, pages
        must be freed on THAT shard) and whose priority does NOT exceed
        the needy slot's (a low-priority arrival must never evict a
        higher-priority runner — it defers instead): lowest priority
        first; within a priority level prefer sequences NOT resumed this
        tick (anti-thrash — a same-tick swap-in/swap-out round trip
        wastes the page-in), then the newest. The needy slot itself is a
        legal victim — self-preemption frees the batch for others. None
        when no eligible victim exists (the caller self-preempts/defers
        the needy slot)."""
        cands = self._victim_candidates(ex, needy, shard)
        return cands[0] if cands else None

    def _preempt(self, ex: Executor, slot: int) -> None:
        st = self.running.pop(slot)
        self._pf_wait.pop(slot, None)
        swapped = ex.exec_preempt(slot, self.cfg.swap)
        self.stats.preemptions += 1
        if swapped:
            self.stats.swap_outs += 1
        else:
            self.stats.recomputes += 1
        self.waiting.append(_Waiting(st.req, st.seqno, swapped=swapped))
