"""EngineCore — the one executor state machine behind every paged-pool
serving backend.

``PagedServingEngine`` and ``SpatialServingEngine`` used to carry two
drifting copies of the identical serving scaffold: admission binding,
chunked prefill, the batched varlen prefill's phase A (pending-cursor
allocation) / phase A2 (same-tick prefix dedup) / wave split / commit,
the fused decode loop, lazy cold-page shedding, and preempt/swap-in.
Every scheduler-visible behavior now lives HERE, once, driven through a
small formal ``Backend`` protocol that covers only what genuinely
differs between a single page pool and a sharded mesh deployment:

* pool primitives — allocate a chunk's pages, look up / register prefix
  keys, drop references (``alloc_chunk`` / ``lookup_prefix`` /
  ``register_prefix`` / ``decref_page`` / ``release_table``);
* dispatch primitives — run one chunk, one batched wave, or one fused
  decode step on the device(s) (``dispatch_chunk`` / ``dispatch_wave``
  / ``decode_step``);
* swap hooks — gather page rows to the host and write them back
  (``gather_park`` / ``upload_park`` / ``page_in_extend``), with ONE
  payload layout (flat page axis) so the host ``SwapArea`` format is
  backend-agnostic and the lazy-shed machinery works everywhere.

``EngineCore`` implements the ``serving.scheduler.Executor`` protocol —
``engine.step()`` is one scheduler tick — and owns all host-side
sequence state: slot binding, block tables, prefill cursors, decode
budgets, the swap area. A backend owns only device state (pool slabs,
device kernels) and pool bookkeeping. New scheduler or engine features
(lazy shed, batched prefill, budget autotuning) therefore land once and
every backend inherits them; the spatial engine's lazy cold-page shed
exists purely because this class hosts the paged engine's.

Most callers should not touch this class directly — the front-door
``repro_torch.serving.api.LLM`` wraps it (see docs/serving.md).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.kvcache import PoolExhausted, SwapArea, bucketing
from repro_torch.obs import (NULL_TELEMETRY, DlzsAuditor, fold_snapshot,
                       fold_traffic, reconcile_refs)
from repro_torch.serving import swap_policy
from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import (SLA_DEADLINES_MS, ExecFault,
                                     NeedPages, Scheduler, SchedulerCfg)
from repro_torch.serving.swap_policy import PrefillProgress as _PrefillProgress
from repro_torch.tree import tree_leaves, tree_map


@runtime_checkable
class Backend(Protocol):
    """Device/pool primitives a serving backend provides to EngineCore.

    A backend is a *stateless policy-free* device driver: it never
    decides WHO runs — it allocates, dispatches, and moves page bytes
    when the core asks. All page addressing at this boundary is by
    GLOBAL logical page index ``j`` (a position in a sequence's block
    table); the backend maps ``j`` to whatever pool/shard owns it.
    """

    # -- static shape/config facts -------------------------------------
    cfg: object                  # model config (vocab, pattern, ...)
    params: object
    page_size: int
    max_batch: int
    eos_id: int
    greedy: bool
    temperature: float
    bucket_pow2: bool
    share: bool                  # effective prefix sharing
    keep_recent: int             # newest pages a lazy shed must keep
    batched: bool                # batched varlen prefill configured
    budget_tokens: Optional[int]  # flat-buffer width (one compile)
    batch_wp: Optional[int]      # past-arena width (per pool shard)
    decode_sparsity: Optional[dict]
    # Last decode step's sparsity telemetry: {"pages_total": resident
    # pages a dense gather would touch, "pages_hot": pages the bounded
    # DLZS hot-width selection kept, "shard_skips": shards that skipped
    # their psum merge}. None before the first decode; the core turns it
    # into engine_decode_pages_skipped_total /
    # engine_decode_shard_merges_skipped_total counters.

    # -- admission ------------------------------------------------------
    def check_capacity(self, rid: int, total_tokens: int,
                       need_pages: int) -> None:
        """Raise ValueError when the request could NEVER fit."""

    # -- pool primitives ------------------------------------------------
    def alloc_chunk(self, pf, start_page: int, n_need: int
                    ) -> tuple[list[int], list[int], bool]:
        """Share/allocate pages for global range [start_page,
        start_page+n_need). Returns (pages, fresh_globals, sharing);
        raises PoolExhausted (``.shard`` names a starved pool shard)."""

    def release_pages(self, pages: list[int], start_global: int) -> None:
        """Decref not-yet-committed chunk pages (globals from
        ``start_global``)."""

    def release_table(self, table: list[int]) -> None:
        """Drop a sequence's references (negative SHED entries skipped)."""

    def lookup_prefix(self, g: int, key: tuple) -> Optional[int]: ...

    def register_prefix(self, g: int, key: tuple, pid: int) -> None: ...

    def forget_prefix(self, g: int, pid: int) -> None:
        """Drop page ``pid``'s prefix-index entry (no-op when it was
        never registered). Fault recovery: a batched prefill registers
        fresh pages before the wave dispatch writes them (same-tick
        dedup), so a dispatch failure must un-register those pages or a
        later identical prompt would revive garbage."""

    def decref_page(self, g: int, pid: int) -> None: ...

    def register_prompt_pages(self, toks, table, fresh_globals,
                              start_page: int) -> None: ...

    def ref_of(self, table, j: int) -> int: ...

    def held_pages(self, table, shard: Optional[int]) -> int: ...

    def page_on_shard(self, j: int, shard: Optional[int]) -> bool:
        """Does freeing global page ``j`` relieve pool shard ``shard``?
        Single-pool backends always say True."""

    # -- prefill dispatch ------------------------------------------------
    def dispatch_chunk(self, pf, table, start: int, end: int, width: int,
                       last_idx: int, pages: list[int],
                       fresh_globals: list[int]):
        """Compute + scatter ONE chunk; returns the logits row of
        ``last_idx`` (legacy per-sequence path). May stay a device
        array — the core only materializes the FINAL chunk's row."""

    def arena_cost(self, past_pages: int) -> list[int]:
        """Per-pool-shard past-arena slots a lane with ``past_pages``
        past pages occupies in a batched wave."""

    def dispatch_wave(self, flat, seg, pos, past_len, last_index,
                      lanes: list[dict]) -> dict[int, np.ndarray]:
        """Run one batched varlen wave (shared flat buffers prepacked by
        the core; ``lanes`` carry per-slot tables/pages/fresh sets) and
        return {slot: host logits row}."""

    # -- decode ----------------------------------------------------------
    def decode_step(self, slots, tables, lengths) -> torch.Tensor:
        """Grow/COW tail pages, select hot pages, run the fused decode;
        returns device logits [max_batch, >=vocab]. Raises NeedPages."""

    def set_last_token(self, slot: int, tok: int) -> None: ...

    def get_last_token(self, slot: int) -> int: ...

    def commit_tokens(self, next_tokens: torch.Tensor) -> None:
        """Install the sampled tokens as the next decode input."""

    # -- shed / swap ------------------------------------------------------
    def hot_logical(self, table) -> set[int]:
        """Global logical indices the decode gather currently keeps hot."""

    def gather_park(self, table, js: list[int]):
        """Pull pages ``js`` to the host as a tree whose page axis (1) is
        flat payload order — one layout for every backend, so shed and
        swap payloads concatenate with ``concat_rows``."""

    def can_hold(self, park_js: list[int]) -> bool:
        """Cheap pre-check: could the pool(s) supply ``park_js`` now?"""

    def page_in_extend(self, park_js: list[int]):
        """Return a ``j -> fresh pid`` allocator for a page-in plan
        (scores pulled once up front). May raise PoolExhausted lazily."""

    def upload_park(self, rows, uploads: list[tuple[int, int, int]]
                    ) -> None:
        """Write payload rows back: ``uploads`` is [(payload position,
        global index j, physical id)]."""

    # -- observability ----------------------------------------------------
    page_bytes_full: int     # full-tree bytes one page carries (swap price)
    page_bytes_gather: int   # fp K/V bytes a decode gather reads per page
    page_bytes_int8: int     # int8 mirror-tier bytes per page (0: no tier)

    def stats(self) -> dict: ...

    def page_accounting(self) -> dict:
        """Host-side pool census: {capacity, live, free, cached, shared,
        unique, quantized_live, quantize_events, per_shard} (``per_shard``
        None for single-pool backends, else rows with a ``shard`` key)."""

    def pool_refs(self) -> dict:
        """(shard, pid) -> refcount for every live page — the watchdog
        reconciles this against what the engine's tables imply."""

    def owner_of(self, j: int) -> int:
        """Pool shard owning global logical page ``j`` (0: single pool)."""

    def audit_decode(self, slot: int, table, length: int
                     ) -> Optional[dict]:
        """Exact-attention audit probe over one decode sequence's full
        resident page set (see obs.audit); None at a page boundary."""


def concat_rows(a, b):
    """Join two flat-payload host row trees along the page axis."""
    return tree_map(lambda x, y: np.concatenate([x, y], axis=1), a, b)


def _rows_bytes(rows) -> int:
    return 0 if rows is None else sum(
        leaf.nbytes for leaf in tree_leaves(rows))


class EngineCore:
    """Scheduler-driven executor over a ``Backend``.

    Single-step flow (``step()`` = one scheduler tick):
      admit   — swap preempted sequences back in, bind waiting requests
                to free slots (no page allocation yet)
      prefill — with a ``SchedulerCfg.prefill_tokens`` budget: pack
                chunks of EVERY prefilling prompt (consecutive chunks
                merge) into ONE batched varlen dispatch; legacy path: up
                to ``prefill_per_step`` one-sequence chunk dispatches
      decode  — one fused decode step over every decode-phase slot;
                finished sequences are reaped and their pages released
    """

    def __init__(self, backend: Backend,
                 scfg: Optional[SchedulerCfg] = None,
                 generator: Optional[torch.Generator] = None):
        self.backend = backend
        self.cfg = backend.cfg
        # sampling stream (non-greedy decode); lives on the backend's
        # device so torch.multinomial draws there without a host copy
        self.generator = generator
        if generator is None:
            self.generator = torch.Generator(device=backend.device)
            self.generator.manual_seed(0)
        self.sched = Scheduler(scfg or SchedulerCfg())
        if backend.batched and self.sched.cfg.prefill_tokens == "auto":
            chunk_tok = self.sched.cfg.chunk_pages * backend.page_size
            self.sched.attach_budget(lo=chunk_tok,
                                     hi=backend.budget_tokens,
                                     quantum=backend.page_size)

        self.swap_area = SwapArea()
        self.active: dict[int, Request] = {}       # slot -> request
        self.budget: dict[int, int] = {}           # decode tokens left
        self.tables: dict[int, list[int]] = {}     # slot -> block table
        self._pf: dict[int, _PrefillProgress] = {}  # slots mid-prefill
        self._prefill_done: list[tuple[int, Request]] = []  # finished at
        #                              prefill (budget 0): reaped next decode
        self._terminal: list[Request] = []  # aborted (cancelled/expired/
        #                              failed) requests not yet drained
        #                              through step()'s finished stream
        self.lengths = np.zeros((backend.max_batch,), np.int64)
        self.free = list(range(backend.max_batch))

        self.tel = getattr(backend, "tel", None) or NULL_TELEMETRY
        self._tick_no = 0
        self._compiled: set = set()       # dispatch kinds seen (compile
        #                                   detection via first-call timing)
        self._sched_seen: dict[str, int] = {}  # last counter sync values
        self.auditor = DlzsAuditor()      # sampled DLZS prediction audit
        self._quant_seen = 0              # last quantize_events sync value
        self._last_pages_hot: Optional[int] = None  # hot_set change events

    @property
    def params(self):
        return self.backend.params

    def attach_telemetry(self, tel) -> None:
        """Share one ``obs.Telemetry`` across the core, the scheduler,
        and the backend (backends emit shard-tagged arena events)."""
        self.tel = tel
        self.sched.tel = tel
        self.backend.tel = tel

    # -- queueing -----------------------------------------------------------

    def submit(self, req: Request):
        if req.max_len is not None and req.max_len <= len(req.prompt):
            raise ValueError(
                f"request {req.rid}: max_len {req.max_len} leaves no room "
                f"after a {len(req.prompt)}-token prompt")
        total = len(req.prompt) + req.max_tokens
        if req.max_len is not None:
            total = min(total, req.max_len)
        need = -(-total // self.backend.page_size)
        self.backend.check_capacity(req.rid, total, need)
        req.out = []
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        if self.sched.cfg.sla_deadlines and req.sla is not None:
            ttft_ms, e2e_ms = SLA_DEADLINES_MS.get(req.sla, (None, None))
            if req.ttft_deadline_ms is None:
                req.ttft_deadline_ms = ttft_ms
            if req.deadline_ms is None:
                req.deadline_ms = e2e_ms
        if self.tel.enabled:
            self.tel.timeline(req.rid, sla=getattr(req, "sla", None))
        self.sched.submit(req)

    @property
    def queue(self) -> list[Request]:
        """Waiting work (fresh + preempted), highest priority first."""
        return self.sched.queued_requests()

    # -- executor protocol: admission --------------------------------------

    def free_slot_available(self) -> bool:
        return bool(self.free)

    def exec_admit(self, req: Request) -> int:
        """Bind a request to a slot. Pages come later, chunk by chunk.

        A request carrying prior output is a recompute-resume: its emitted
        tokens are appended to the prompt and replayed through prefill
        (exact under greedy decode), with the final sampled token
        suppressed — it was already emitted before preemption."""
        slot = self.free.pop(0)
        out = req.out or []
        if out:
            prompt = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(out[:-1], np.int64)])
        else:
            prompt = np.asarray(req.prompt, np.int64)
        spans = bucketing.chunk_spans(
            len(prompt), self.backend.page_size, self.sched.cfg.chunk_pages,
            pow2=self.backend.bucket_pow2)
        share = self.backend.share
        self._pf[slot] = _PrefillProgress(
            prompt=prompt,
            toks=tuple(int(x) for x in prompt) if share else None,
            spans=spans, chunk=0, sharing=share,
            suppress_first=bool(out))
        self.tables[slot] = []
        self.active[slot] = req
        self.lengths[slot] = 0
        if self.tel.enabled:
            tl = self.tel.timeline(req.rid)
            now = time.perf_counter()
            if out:                        # recompute-mode resume
                tl.resume_ts.append(now)
            elif tl.admit_t is None:
                tl.admit_t = now
            self.tel.tracer.instant("admit", rid=req.rid, slot=slot,
                                    resume=bool(out))
            self.tel.recorder.record("admit", tick=self._tick_no,
                                     rid=req.rid, slot=slot,
                                     resume=bool(out))
        return slot

    def prefill_chunks_left(self, slot: int) -> int:
        pf = self._pf.get(slot)
        return 0 if pf is None else len(pf.spans) - pf.chunk

    def held_pages(self, slot: int, shard: Optional[int] = None) -> int:
        return self.backend.held_pages(self.tables.get(slot, ()), shard)

    # -- executor protocol: chunked prefill ---------------------------------

    def _alloc_chunk(self, slot: int, pf, start_page: int, n_need: int):
        """Backend allocation with pool pressure translated into the
        scheduler's NeedPages signal (shard-tagged when the backend's
        exhaustion names a starved pool shard)."""
        try:
            return self.backend.alloc_chunk(pf, start_page, n_need)
        except PoolExhausted as e:
            shard = getattr(e, "shard", None)
            if self.tel.enabled:
                self.tel.tracer.instant("need_pages", slot=slot,
                                        where="prefill", shard=shard,
                                        pages=n_need)
                self.tel.metrics.counter(
                    "engine_need_pages_total",
                    "pool-pressure signals raised").inc(where="prefill")
            raise NeedPages(slot, shard) from None

    def _finish_prefill(self, slot: int, pf, logits_row, done_out=None
                        ) -> None:
        """Prompt complete: emit the first token, enter decode phase (or
        reap immediately when the token budget is already spent)."""
        req = self.active[slot]
        if pf.suppress_first:
            tok = int(req.out[-1])
        else:
            tok = int(np.argmax(logits_row[:self.cfg.vocab]))
            req.out.append(tok)
        del self._pf[slot]
        self.lengths[slot] = len(pf.prompt)
        self.backend.set_last_token(slot, tok)
        self.budget[slot] = req.max_tokens - len(req.out)
        if self.tel.enabled and not pf.suppress_first:
            tl = self.tel.timeline(req.rid)
            if tl.first_token_t is None:
                tl.first_token_t = time.perf_counter()
        if done_out is not None:
            done_out.append(slot)
        if self.budget[slot] <= 0:     # e.g. max_tokens=1: done at prefill
            self.backend.release_table(self.tables.pop(slot))
            del self.active[slot]
            del self.budget[slot]
            self.lengths[slot] = 0
            self.free.append(slot)
            req.finish_reason = "done"
            self._prefill_done.append((slot, req))
            if self.tel.enabled:
                self._stamp_done(req, "done")

    def _stamp_done(self, req: Request, outcome: str) -> None:
        """Close a request's timeline and bump the finish counters."""
        tl = self.tel.timeline(req.rid)
        tl.done_t = time.perf_counter()
        tl.n_tokens = len(req.out or ())
        tl.outcome = outcome
        sla = getattr(req, "sla", None) or "default"
        self.tel.metrics.counter(
            "engine_requests_finished_total",
            "requests completed").inc(sla=sla)
        self.tel.metrics.counter(
            "engine_tokens_total",
            "tokens emitted by finished requests").inc(tl.n_tokens,
                                                       sla=sla)
        if tl.ttft is not None:
            self.tel.metrics.histogram(
                "engine_ttft_seconds",
                "time to first token").observe(tl.ttft, sla=sla)

    # -- lifecycle: cancellation / deadlines / quarantine --------------------

    _ABNORMAL_EVENT = {"cancelled": "cancel", "expired": "deadline_expired",
                       "failed": "quarantine"}

    def _finish_abnormal(self, req: Request, outcome: str,
                         reason: str) -> None:
        """Stamp a terminal CANCELLED/EXPIRED/FAILED state. The request
        joins ``_terminal`` so the next step() surfaces it through the
        finished stream (the LLM front door closes its record there).
        Aborts bump their own counter, NOT the finished/token counters —
        per-SLA goodput only ever counts work that completed."""
        req.finish_reason = outcome
        self._terminal.append(req)
        if not self.tel.enabled:
            return
        tl = self.tel.timeline(req.rid)
        if tl.done_t is None:
            tl.done_t = time.perf_counter()
        tl.n_tokens = len(req.out or ())
        tl.outcome = outcome
        sla = getattr(req, "sla", None) or "default"
        self.tel.metrics.counter(
            "engine_requests_aborted_total",
            "requests ended abnormally").inc(sla=sla, outcome=outcome)
        self.tel.recorder.record(
            self._ABNORMAL_EVENT[outcome], tick=self._tick_no,
            rid=req.rid, reason=reason, tokens=len(req.out or ()))

    def _teardown_slot(self, slot: int) -> Request:
        """Release everything a bound slot holds: pending chunk pages,
        the block table (COW-shared pages decref only — another owner
        keeps them live), any lazy-shed swap payload, budget, length."""
        req = self.active.pop(slot)
        table = self.tables.pop(slot)
        pf = self._pf.pop(slot, None)
        swap_policy.release_pending(
            pf, lambda pgs: self.backend.release_pages(pgs, len(table)))
        self.backend.release_table(table)
        self.swap_area.discard(req.rid)
        self.budget.pop(slot, None)
        self.lengths[slot] = 0
        self.free.append(slot)
        return req

    def cancel(self, rid: int, *, outcome: str = "cancelled",
               reason: str = "client") -> bool:
        """Terminate a request wherever it is — mid-prefill, mid-decode,
        waiting fresh, or fully swapped out. Frees every page it solely
        owns (shared pages decref), discards parked payloads, stamps the
        terminal timeline state. False when the rid is not in flight."""
        for slot, req in list(self.active.items()):
            if req.rid == rid:
                self.sched.drop_running_slot(slot)
                self._teardown_slot(slot)
                self._finish_abnormal(req, outcome, reason)
                return True
        req = self.sched.drop_waiting(rid)
        if req is not None:
            payload = self.swap_area.discard(rid)
            if payload:
                # a parked sequence still holds refs on its shared pages
                for j, pid in payload.get("kept", ()):
                    self.backend.decref_page(j, pid)
            self._finish_abnormal(req, outcome, reason)
            return True
        return False

    def exec_abort(self, req: Request, outcome: str, reason: str) -> None:
        """Scheduler-initiated terminal state for a NON-running request
        (quarantine past the retry budget, admission shed)."""
        payload = self.swap_area.discard(req.rid)
        if payload:
            for j, pid in payload.get("kept", ()):
                self.backend.decref_page(j, pid)
        self._finish_abnormal(req, outcome, reason)

    def _expire_deadlines(self) -> None:
        """Sweep TTFT/end-to-end budgets over everything in flight; runs
        at the top of every step so an expired request never consumes
        another tick's worth of pool or dispatch."""
        now = time.perf_counter()
        expired = [req.rid for req in self.active.values()
                   if req.deadline_exceeded(now)]
        expired += [w.req.rid for w in self.sched.waiting
                    if w.req.deadline_exceeded(now)]
        for rid in expired:
            self.cancel(rid, outcome="expired", reason="deadline")

    def _note_fault(self, slots, err: BaseException, where: str) -> None:
        if not self.tel.enabled:
            return
        kind = "fault_injected" if getattr(err, "is_injected", False) \
            else "fault"
        self.tel.recorder.record(kind, tick=self._tick_no, where=where,
                                 slots=list(slots),
                                 error=type(err).__name__)
        self.tel.metrics.counter(
            "engine_faults_total",
            "backend failures isolated to their requests").inc(
            where=where)

    def _purge_pending(self, slots) -> None:
        """Roll every listed slot's batched-prefill cursor back to the
        last committed chunk: un-register fresh pages phase A2 indexed
        (their content never landed — the dispatch failed) and release
        the pending allocation. The next attempt re-allocates cleanly."""
        for slot in slots:
            pf = self._pf.get(slot)
            if pf is None or pf.pending is None:
                continue
            pages, fresh, _ = pf.pending
            start_page = len(self.tables[slot])
            for g in fresh:
                self.backend.forget_prefix(g, pages[g - start_page])
            self.backend.release_pages(pages, start_page)
            pf.pending = None

    def exec_prefill_chunk(self, slot: int) -> bool:
        """Share/allocate + compute + scatter ONE chunk of ``slot``'s
        prompt. Returns True once the prompt is complete (slot enters
        decode). Raises NeedPages when the pool cannot supply the chunk."""
        pf = self._pf[slot]
        page = self.backend.page_size
        start, end, width = pf.spans[pf.chunk]
        start_page = start // page
        n_need = -(-end // page) - start_page
        pages, fresh_globals, sharing = self._alloc_chunk(
            slot, pf, start_page, n_need)
        pf.sharing = sharing
        table = self.tables[slot]
        table.extend(pages)
        t = len(pf.prompt)
        last = pf.chunk == len(pf.spans) - 1
        if self.tel.enabled and pf.chunk == 0:
            tl = self.tel.timeline(self.active[slot].rid)
            if tl.first_chunk_t is None:
                tl.first_chunk_t = time.perf_counter()

        logits = None
        if fresh_globals or last:  # fully-shared middle chunks skip compute
            last_idx = (t - 1 if last else end - 1) - start
            kind = ("chunk", width)
            try:
                with self.tel.tracer.span(
                        "prefill.chunk", slot=slot, width=width,
                        compile=kind not in self._compiled):
                    logits = self.backend.dispatch_chunk(
                        pf, table, start, end, width, last_idx, pages,
                        fresh_globals)
            except NeedPages:
                raise
            except Exception as err:
                # isolate to this request: its pages (all in the table
                # by now, none prefix-registered yet — the sequential
                # path registers after compute) fall with it in the
                # recompute preemption the scheduler now issues
                self._note_fault([slot], err, "prefill")
                raise ExecFault([slot], err, "prefill") from err
            self._compiled.add(kind)
            if self.backend.share and pf.toks is not None:
                self.backend.register_prompt_pages(pf.toks, table,
                                                   fresh_globals,
                                                   start_page)
        pf.chunk += 1
        if not last:
            return False
        self._finish_prefill(slot, pf, logits)
        return True

    # -- executor protocol: batched varlen chunk prefill --------------------

    def pending_chunk_widths(self, slot: int) -> list[int]:
        pf = self._pf[slot]
        return [w for _, _, w in pf.spans[pf.chunk:]]

    @staticmethod
    def _merged_span(pf, n: int) -> tuple[int, int, int]:
        """Span covering the next ``n`` CONSECUTIVE chunks as one varlen
        piece: non-final chunks are exactly full, so only the tail can
        pad — merged chunks behave exactly like one larger chunk."""
        start = pf.spans[pf.chunk][0]
        end = pf.spans[pf.chunk + n - 1][1]
        width = sum(w for _, _, w in pf.spans[pf.chunk:pf.chunk + n])
        return start, end, width

    def exec_prefill_chunk_batch(self, batch: list[tuple[int, int]]
                                 ) -> list[int]:
        """Advance every ``(slot, n_chunks)`` entry in ONE compiled
        varlen dispatch over a fixed ``[1, budget_tokens]`` flat buffer.

        Three phases: (A) allocate each slot's merged-span pages —
        idempotent via ``pf.pending``, so a NeedPages retry after
        preemption reuses what already succeeded; (A2) same-tick prefix
        dedup; (B) pack the spans back to back into the flat buffer
        (segment ids, absolute positions) and hand the wave to the
        backend's dispatch — fully prefix-shared non-final spans need no
        lanes at all; (C) commit: extend tables, advance cursors, emit
        first tokens for completed prompts. Nothing commits before the
        dispatch succeeds, so a phase-A NeedPages leaves every pending
        cursor untouched. In the rare case the packed spans' pasts
        overflow the fixed arena, phase B splits into several same-shape
        waves (still one compilation). Returns the slots entering
        decode."""
        page = self.backend.page_size
        pack_span = self.tel.tracer.span("prefill.pack", slots=len(batch))
        pack_span.__enter__()
        for slot, n in batch:                  # phase A: allocation
            pf = self._pf[slot]
            if pf.pending is not None:
                continue
            n = max(1, min(n, len(pf.spans) - pf.chunk))
            start, end, _ = self._merged_span(pf, n)
            start_page = start // page
            n_need = -(-end // page) - start_page
            try:
                pages, fresh_globals, sharing = self._alloc_chunk(
                    slot, pf, start_page, n_need)
            except NeedPages:
                pack_span.__exit__(None, None, None)
                raise
            pf.sharing = sharing
            pf.pending = (pages, fresh_globals, n)
            if self.tel.enabled and pf.chunk == 0:
                tl = self.tel.timeline(self.active[slot].rid)
                if tl.first_chunk_t is None:
                    tl.first_chunk_t = time.perf_counter()

        # Phase A2 — same-tick prefix dedup. Batched admission runs many
        # same-prefix prompts' chunks in ONE tick, so the ordinary
        # register-after-compute flow would never let them share (each
        # allocates before any registers). Once every allocation above
        # succeeded nothing can raise before the dispatch commits, so it
        # is safe to register fresh full prompt pages NOW and point later
        # slots in the batch at them — the owning lane's scatter writes
        # the content within this same dispatch.
        slots = [s for s, _ in batch]
        if self.backend.share:
            for slot in slots:
                pf = self._pf[slot]
                if pf.toks is None:
                    continue
                pages, fresh_globals, n = pf.pending
                start_page = pf.spans[pf.chunk][0] // page
                fresh_set = set(fresh_globals)
                new_fresh = []
                for cj, pid in enumerate(pages):
                    g = start_page + cj
                    if g not in fresh_set:
                        continue
                    end = (g + 1) * page
                    if end > len(pf.toks):
                        new_fresh.append(g)
                        continue
                    key = pf.toks[:end]
                    hit = self.backend.lookup_prefix(g, key)
                    if hit is not None:        # an earlier lane owns it
                        self.backend.decref_page(g, pid)
                        pages[cj] = hit
                    else:
                        self.backend.register_prefix(g, key, pid)
                        new_fresh.append(g)
                pf.pending = (pages, new_fresh, n)

        def is_last(slot):
            pf = self._pf[slot]
            return pf.chunk + pf.pending[2] == len(pf.spans)

        compute = [s for s in slots
                   if self._pf[s].pending[1] or is_last(s)]

        # wave split: spans whose combined past pages (or tokens, after a
        # pressure retry reshuffled the batch) overflow the fixed buffers
        # spill to a follow-up dispatch of the SAME compiled shape. Past
        # cost is per pool shard (a striped backend fills several arenas)
        waves: list[list[int]] = []
        cur: list[int] = []
        cur_p: Optional[list[int]] = None
        cur_t = 0
        for slot in compute:
            pf = self._pf[slot]
            start, _, width = self._merged_span(pf, pf.pending[2])
            cost = self.backend.arena_cost(start // page)
            if cur and (cur_t + width > self.backend.budget_tokens
                        or any(c + d > self.backend.batch_wp
                               for c, d in zip(cur_p, cost))):
                waves.append(cur)
                cur, cur_p, cur_t = [], None, 0
            cur.append(slot)
            cur_p = cost if cur_p is None \
                else [c + d for c, d in zip(cur_p, cost)]
            cur_t += width
        if cur:
            waves.append(cur)
        pack_span.args["waves"] = len(waves)
        pack_span.__exit__(None, None, None)
        if len(waves) > 1:
            self.tel.metrics.counter(
                "engine_wave_splits_total",
                "batched prefills split into extra waves").inc(
                len(waves) - 1)

        logits_by_slot: dict[int, np.ndarray] = {}
        for i, wave in enumerate(waves):       # phase B: dispatch(es)
            first = "wave" not in self._compiled
            try:
                with self.tel.tracer.span("prefill.dispatch", wave=i,
                                          lanes=len(wave), compile=first):
                    self._dispatch_chunk_wave(wave, logits_by_slot)
            except NeedPages:
                raise
            except Exception as err:
                # nothing has committed (phase C never ran): roll every
                # batch slot's pending cursor back — crucially
                # un-registering the phase-A2 prefix entries whose page
                # content this dispatch was supposed to write — and
                # blame only the failing wave's slots; the rest repack
                # and redispatch cleanly on the scheduler's retry
                self._purge_pending(slots)
                self._note_fault(wave, err, "prefill")
                raise ExecFault(wave, err, "prefill") from err
            self._compiled.add("wave")

        done: list[int] = []
        with self.tel.tracer.span("prefill.commit", slots=len(slots)):
            for slot in slots:                 # phase C: commit
                pf = self._pf[slot]
                pages, fresh_globals, n = pf.pending
                self.tables[slot].extend(pages)
                # prefix registration already happened in phase A2 — the
                # sole registration point, which is what makes same-tick
                # sharing safe (content lands via this dispatch's scatter)
                pf.pending = None
                pf.chunk += n
                if pf.chunk < len(pf.spans):
                    continue
                self._finish_prefill(slot, pf, logits_by_slot.get(slot),
                                     done_out=done)
        return done

    def _dispatch_chunk_wave(self, wave: list[int],
                             logits_by_slot: dict) -> None:
        """Pack one wave of merged spans into the shared flat buffer
        (tokens, segment ids, absolute positions, per-lane past lengths
        and last indices) and hand it to the backend dispatch, which
        adds its pool-specific past arena + scatter targets."""
        page = self.backend.page_size
        b_tok, lanes_n = self.backend.budget_tokens, self.backend.max_batch
        flat = np.zeros((b_tok,), np.int32)
        seg = np.full((b_tok,), -1, np.int32)
        pos = np.zeros((b_tok,), np.int32)
        past_len = np.zeros((lanes_n,), np.int32)
        last_index = np.zeros((lanes_n,), np.int32)
        cursor = 0
        lanes: list[dict] = []
        for slot in wave:
            pf = self._pf[slot]
            pages, fresh_globals, n = pf.pending
            start, end, width = self._merged_span(pf, n)
            last = pf.chunk + n == len(pf.spans)
            t = len(pf.prompt)
            flat[cursor:cursor + width] = bucketing.pad_tokens(
                pf.prompt[start:end], width)
            seg[cursor:cursor + width] = slot
            pos[cursor:cursor + width] = start + np.arange(width)
            last_index[slot] = cursor + (t - 1 if last else end - 1) \
                - start
            past_len[slot] = start
            lanes.append({"slot": slot, "table": self.tables[slot],
                          "pages": pages, "fresh": set(fresh_globals),
                          "start_page": start // page,
                          "base": cursor // page})
            cursor += width
        logits_by_slot.update(self.backend.dispatch_wave(
            flat, seg, pos, past_len, last_index, lanes))

    # -- executor protocol: decode ------------------------------------------

    def _decode_slots(self) -> list[int]:
        return [s for s in self.active if s not in self._pf]

    def exec_decode(self) -> list[tuple[int, Request]]:
        slots = self._decode_slots()
        if not slots:
            done_early, self._prefill_done = self._prefill_done, []
            return done_early
        # may raise NeedPages (tail-page growth) — drain the
        # prefill-finished list only once nothing can raise anymore.
        # The span covers dispatch THROUGH the host sync (.cpu()):
        # device dispatch is async, so device time only shows at the sync.
        first = "decode" not in self._compiled
        with self.tel.tracer.span("decode.step", lanes=len(slots),
                                  compile=first):
            try:
                logits = self.backend.decode_step(slots, self.tables,
                                                  self.lengths)
            except NeedPages as e:
                if self.tel.enabled:
                    self.tel.tracer.instant("need_pages", slot=e.slot,
                                            where="decode",
                                            shard=e.shard)
                    self.tel.metrics.counter(
                        "engine_need_pages_total",
                        "pool-pressure signals raised").inc(where="decode")
                raise
            except Exception as err:
                # the fused step blames every decode slot — each falls
                # back to recompute replay (exact under greedy decode),
                # so innocents still finish with identical output
                self._note_fault(slots, err, "decode")
                raise ExecFault(slots, err, "decode") from err
            done_early, self._prefill_done = self._prefill_done, []
            logits = logits[:, :self.cfg.vocab]
            if self.backend.greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(
                    logits.float() / self.backend.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1,
                                        generator=self.generator)[:, 0]
            self.backend.commit_tokens(nxt)
            nxt_host = nxt.cpu().numpy()
        self._compiled.add("decode")
        sparsity = getattr(self.backend, "decode_sparsity", None)
        if self.tel.enabled and sparsity:
            skipped = sparsity["pages_total"] - sparsity["pages_hot"]
            self.tel.metrics.counter(
                "engine_decode_pages_considered_total",
                "resident pages a dense decode gather would have "
                "touched").inc(sparsity["pages_total"])
            if skipped > 0:
                self.tel.metrics.counter(
                    "engine_decode_pages_skipped_total",
                    "resident pages the bounded DLZS hot-width decode "
                    "gather left cold").inc(skipped)
                self.tel.metrics.counter(
                    "engine_decode_bytes_skipped_total",
                    "fp K/V bytes the bounded hot-width gather did NOT "
                    "read (measured bytes-not-gathered)").inc(
                    skipped * getattr(self.backend, "page_bytes_gather", 0))
            if sparsity.get("shard_skips"):
                self.tel.metrics.counter(
                    "engine_decode_shard_merges_skipped_total",
                    "per-step shards holding zero hot pages whose psum "
                    "contribution was skipped").inc(sparsity["shard_skips"])
            if sparsity["pages_hot"] != self._last_pages_hot:
                self.tel.recorder.record(
                    "hot_set", tick=self._tick_no,
                    pages_hot=sparsity["pages_hot"],
                    pages_total=sparsity["pages_total"])
                self._last_pages_hot = sparsity["pages_hot"]
        finished = done_early
        tel_on = self.tel.enabled
        now = time.perf_counter() if tel_on else 0.0
        for slot in slots:
            req = self.active[slot]
            tok = int(nxt_host[slot])
            req.out.append(tok)
            self.lengths[slot] += 1
            self.budget[slot] -= 1
            if tel_on:
                self.tel.timeline(req.rid).token_ts.append(now)
            limit = req.max_len
            done = (tok == self.backend.eos_id or self.budget[slot] <= 0
                    or (limit is not None
                        and self.lengths[slot] + 1 >= limit))
            if done:
                self.backend.release_table(self.tables.pop(slot))
                self.swap_area.discard(req.rid)   # lazily-shed pages
                del self.active[slot]
                del self.budget[slot]
                self.lengths[slot] = 0
                self.free.append(slot)
                req.finish_reason = "done"
                finished.append((slot, req))
                if tel_on:
                    self._stamp_done(req, "done")
        return finished

    # -- executor protocol: lazy shed / preemption / swap -------------------

    def exec_shed_cold(self, slot: int, shard: Optional[int] = None
                       ) -> int:
        """Lazy swap: park the slot's DLZS-cold uniquely-owned pages on
        the host while it KEEPS decoding. Only pages outside both the
        recent window and the current hot-page selection are shed — pages
        the decode gather was already skipping — so the victim's hot-set
        output is unchanged; the pool just gets its cold pages back.
        Table entries become the SHED sentinel; a later full preemption
        merges the shed payload into the ordinary swap payload. When the
        pressure names a starved pool shard, only pages owned there are
        shed (freeing elsewhere would not unblock the needy sequence).
        Returns pages freed (0: mid-prefill, or nothing sheddable)."""
        if slot in self._pf or slot not in self.tables:
            return 0                 # prefill still reads its past pages
        table = self.tables[slot]
        hot = self.backend.hot_logical(table)
        cands = swap_policy.shed_candidates(
            table, hot, int(self.lengths[slot]), self.backend.page_size,
            lambda j: self.backend.ref_of(table, j),
            keep_recent=self.backend.keep_recent)
        cands = [j for j in cands
                 if self.backend.page_on_shard(j, shard)]
        if not cands:
            return 0
        req = self.active[slot]
        with self.tel.tracer.span("shed", slot=slot, rid=req.rid,
                                  pages=len(cands), shard=shard):
            host = self.backend.gather_park(table, cands)
            state = swap_policy.merge_shed(
                {"rows": host, "park": list(cands)},
                self.swap_area.discard(req.rid), concat_rows)
            self.swap_area.put(req.rid, state, _rows_bytes(state["rows"]))
            for j in cands:
                self.backend.decref_page(j, table[j])
                table[j] = swap_policy.SHED
        if self.tel.enabled:
            self.tel.metrics.counter(
                "engine_pages_swapped_total",
                "pages moved between pool and host").inc(
                len(cands), dir="out", kind="shed")
            self.tel.metrics.counter(
                "engine_swap_bytes_total",
                "page bytes moved between pool and host").inc(
                _rows_bytes(host), dir="out", kind="shed")
            self.tel.recorder.record("shed", tick=self._tick_no,
                                     rid=req.rid, slot=slot,
                                     pages=len(cands), shard=shard)
        return len(cands)

    def exec_preempt(self, slot: int, swap: bool) -> bool:
        """Evict ``slot``. swap=True parks its page contents in the host
        SwapArea (resume = page-in); otherwise pages are dropped and the
        sequence recomputes from prompt + emitted tokens on re-admission.

        Shared-prefix-aware parking (swap_policy core): only uniquely-
        owned (ref-1) pages are gathered to the host. A page some other
        sequence also references keeps OUR reference while swapped — its
        content cannot be freed or rewritten underneath us, so resume
        reuses the same physical page with zero upload. Pages a lazy
        shed already parked merge into the payload."""
        req = self.active.pop(slot)
        table = self.tables.pop(slot)
        pf = self._pf.pop(slot, None)
        span = self.tel.tracer.span("preempt", slot=slot, rid=req.rid,
                                    swap=swap)
        span.__enter__()
        swap_policy.release_pending(
            pf, lambda pgs: self.backend.release_pages(pgs, len(table)))
        swapped = False
        if swap and table:
            kept, park, shed = swap_policy.partition_table(
                table, lambda j: self.backend.ref_of(table, j))
            # gather BEFORE decref: page content is only guaranteed
            # until the ids return to the free list
            with self.tel.tracer.span("swap_out", rid=req.rid,
                                      pages=len(park)):
                host = self.backend.gather_park(table, park) \
                    if park else None
            state = swap_policy.progress_state(
                req, pf, share=self.backend.share,
                length=int(self.lengths[slot]),
                last_token=self.backend.get_last_token(slot),
                budget=self.budget.get(slot, 0))
            state.update(rows=host, park=park, kept=kept,
                         n_pages=len(table))
            state = swap_policy.merge_shed(
                state, self.swap_area.discard(req.rid) if shed else None,
                concat_rows)
            self.swap_area.put(req.rid, state, _rows_bytes(state["rows"]))
            # release ONLY the parked pages; kept (shared) pages retain
            # this sequence's reference until it resumes
            for j in park:
                self.backend.decref_page(j, table[j])
            swapped = True
            if self.tel.enabled and park:
                self.tel.metrics.counter(
                    "engine_pages_swapped_total",
                    "pages moved between pool and host").inc(
                    len(park), dir="out", kind="preempt")
                self.tel.metrics.counter(
                    "engine_swap_bytes_total",
                    "page bytes moved between pool and host").inc(
                    _rows_bytes(host), dir="out", kind="preempt")
        else:
            self.swap_area.discard(req.rid)    # stale lazy-shed payload
            self.backend.release_table(table)
        self.budget.pop(slot, None)
        self.lengths[slot] = 0
        self.free.append(slot)
        if self.tel.enabled:
            tl = self.tel.timeline(req.rid)
            tl.preempt_ts.append(time.perf_counter())
            tl.outcome = "preempted"
            self.tel.recorder.record("preempt", tick=self._tick_no,
                                     rid=req.rid, slot=slot, swap=swap,
                                     swapped=swapped)
        span.args["swapped"] = swapped
        span.__exit__(None, None, None)
        return swapped

    def exec_swap_in(self, req: Request) -> Optional[int]:
        """Page a swapped sequence back in, or None if the pool cannot hold
        its block table right now.

        Pages kept live at swap-out (shared at the time) are reused as-is.
        Parked full-prompt pages first retry the prefix index — if an
        identical prefix is pooled (often our own parked copy, cached at
        release), the page revives with no upload; only genuine misses
        allocate a fresh page and upload the parked rows
        (swap_policy.plan_page_in, rollback on exhaustion)."""
        state = self.swap_area.peek(req.rid)
        park = state["park"]
        # conservative: lookups below can only reduce the real need
        if not self.backend.can_hold(park):
            return None
        extend = self.backend.page_in_extend(park)
        plan = swap_policy.plan_page_in(
            park, state["lookup_toks"], self.backend.page_size,
            lookup=lambda j, key: self.backend.lookup_prefix(j, key),
            extend=lambda j: extend(j),
            rollback=lambda j, pid: self.backend.decref_page(j, pid))
        if plan is None:           # defensive: entry stays put, retry later
            return None
        filled, upload = plan
        state = self.swap_area.take(req.rid)   # committed: pages acquired
        for j, pid in state["kept"]:
            filled[j] = pid
        slot = self.free.pop(0)
        try:
            with self.tel.tracer.span("swap_in", rid=req.rid, slot=slot,
                                      uploads=len(upload)):
                pages = [filled[j] for j in range(state["n_pages"])]
                if upload:
                    self.backend.upload_park(
                        state["rows"],
                        [(pos, park[pos], pid) for pos, pid in upload])
                if upload and state.get("register_prefix") \
                        and self.backend.share:
                    # transfer import: index uploaded full-prompt pages
                    # so later same-prefix imports COW-share them here
                    # instead of re-uploading (the plan's lookup already
                    # missed, so each registration is a fresh key)
                    self._register_imported(state, park, upload)
                self.tables[slot] = pages
                self.active[slot] = req
                pf = swap_policy.restore_progress(state)
                if pf is not None:
                    self._pf[slot] = pf
                    self.lengths[slot] = 0
                else:
                    self.lengths[slot] = state["length"]
                    self.backend.set_last_token(slot,
                                                state["last_token"])
                    self.budget[slot] = state["budget"]
        except Exception as err:
            # failed restore (e.g. corrupt payload at upload): the swap
            # entry is already consumed, so drop EVERY page the sequence
            # held — plan-acquired and kept alike — free the slot, and
            # let the scheduler fall back to recompute from the prompt
            # plus already-emitted tokens (exact under greedy decode)
            for j, pid in filled.items():
                self.backend.decref_page(j, pid)
            self.tables.pop(slot, None)
            self.active.pop(slot, None)
            self._pf.pop(slot, None)
            self.budget.pop(slot, None)
            self.lengths[slot] = 0
            self.free.append(slot)
            self._note_fault([], err, "swap_in")
            raise ExecFault([], err, "swap_in", rid=req.rid) from err
        if self.tel.enabled:
            tl = self.tel.timeline(req.rid)
            tl.resume_ts.append(time.perf_counter())
            tl.outcome = None                  # back in flight
            if upload:
                self.tel.metrics.counter(
                    "engine_pages_swapped_total",
                    "pages moved between pool and host").inc(
                    len(upload), dir="in", kind="resume")
                self.tel.metrics.counter(
                    "engine_swap_bytes_total",
                    "page bytes moved between pool and host").inc(
                    len(upload)
                    * getattr(self.backend, "page_bytes_full", 0),
                    dir="in", kind="resume")
            self.tel.recorder.record("swap_in", tick=self._tick_no,
                                     rid=req.rid, slot=slot,
                                     uploads=len(upload),
                                     kept=len(state["kept"]))
        return slot

    def _register_imported(self, state: dict, park, upload) -> None:
        """Prefix-index freshly uploaded full-prompt pages from a
        transfer payload. COW-shared prefixes therefore transfer once:
        the first import materializes and registers them; every later
        same-prefix import's page-in plan hits the index and shares the
        physical page with zero upload."""
        toks = state.get("lookup_toks")
        if not toks:
            return
        page = self.backend.page_size
        for pos, pid in upload:
            j = park[pos]
            end = (j + 1) * page
            if end <= len(toks):
                self.backend.register_prefix(j, tuple(toks[:end]), pid)

    # -- cross-instance transfer hooks (serving.disagg) ----------------------

    def export_request(self, rid: int
                       ) -> Optional[tuple[Request, Optional[dict]]]:
        """Detach a request from THIS instance for a cross-instance
        handoff; returns ``(req, payload)`` or None when ``rid`` is not
        in flight here.

        The payload is the backend-uniform flat swap format with every
        resident page gathered to the host — shared pages included:
        unlike a preemption, the request leaves this instance entirely,
        so no device reference may survive (``kept == []``) and the
        conservation invariant closes the moment this returns. Any
        lazy-shed payload merges in; per-page DLZS scores ride along
        when the backend can supply them. ``payload is None`` means the
        peer must recompute from prompt + emitted tokens (a waiting
        request that never started, or one preempted in recompute mode).
        """
        for slot, req in list(self.active.items()):
            if req.rid != rid:
                continue
            self.sched.drop_running_slot(slot)
            payload = self._export_slot(slot)
            self._note_export(req, payload)
            return req, payload
        for w in list(self.sched.waiting):
            if w.req.rid != rid:
                continue
            swapped = w.swapped
            req = self.sched.drop_waiting(rid)
            payload = self._export_parked(rid) if swapped else None
            if not swapped:
                self.swap_area.discard(rid)        # defensive
            self._note_export(req, payload)
            return req, payload
        return None

    def _export_slot(self, slot: int) -> dict:
        """Gather a bound slot's full state into a transfer payload and
        release everything it holds (mirrors ``exec_preempt``, except
        shared pages are gathered too — the peer's pool knows nothing of
        this pool's physical ids)."""
        req = self.active.pop(slot)
        table = self.tables.pop(slot)
        pf = self._pf.pop(slot, None)
        swap_policy.release_pending(
            pf, lambda pgs: self.backend.release_pages(pgs, len(table)))
        park = [j for j, pid in enumerate(table) if pid >= 0]
        shed = [j for j, pid in enumerate(table) if pid < 0]
        # gather BEFORE any decref: content is only guaranteed while
        # the pages hold at least one reference
        rows = self.backend.gather_park(table, park) if park else None
        state = swap_policy.progress_state(
            req, pf, share=self.backend.share,
            length=int(self.lengths[slot]),
            last_token=self.backend.get_last_token(slot),
            budget=self.budget.get(slot, 0))
        state.update(rows=rows, park=park, kept=[], n_pages=len(table))
        scorer = getattr(self.backend, "export_page_scores", None)
        scores = scorer(table, park) if scorer and park else None
        state = swap_policy.merge_shed(
            state, self.swap_area.discard(req.rid) if shed else None,
            concat_rows)
        if scores is not None:
            # shed pages were DLZS-cold when parked: score them 0 so the
            # advisory list still lines up with the merged park order
            state["scores"] = list(scores) + [0.0] * (
                len(state["park"]) - len(scores))
        state["register_prefix"] = bool(self.backend.share)
        self.backend.release_table(table)
        self.budget.pop(slot, None)
        self.lengths[slot] = 0
        self.free.append(slot)
        return state

    def _export_parked(self, rid: int) -> Optional[dict]:
        """Turn a fully-swapped sequence's payload into a transfer
        payload: ``kept`` pages (shared at preemption, still referenced
        on this pool) are gathered and their references dropped — the
        peer re-materializes them from rows like any parked page."""
        state = self.swap_area.discard(rid)
        if state is None:
            return None
        kept = list(state.get("kept", ()))
        if kept:
            synth = [-1] * state["n_pages"]
            for j, pid in kept:
                synth[j] = pid
            js = [j for j, _ in kept]
            kept_rows = self.backend.gather_park(synth, js)
            rows = kept_rows if state["rows"] is None \
                else concat_rows(state["rows"], kept_rows)
            for j, pid in kept:
                self.backend.decref_page(j, pid)
            state = dict(state, rows=rows,
                         park=list(state["park"]) + js, kept=[])
        else:
            state = dict(state, kept=[])
        state.pop("scores", None)
        state["register_prefix"] = bool(self.backend.share)
        return state

    def _note_export(self, req: Request,
                     payload: Optional[dict]) -> None:
        if not self.tel.enabled:
            return
        pages = len(payload["park"]) if payload else 0
        if pages:
            self.tel.metrics.counter(
                "engine_pages_swapped_total",
                "pages moved between pool and host").inc(
                pages, dir="out", kind="transfer")
        self.tel.recorder.record(
            "transfer_out", tick=self._tick_no, rid=req.rid,
            pages=pages, recompute=payload is None)

    def adopt(self, req: Request, payload: Optional[dict] = None) -> None:
        """Accept a request a peer instance exported.

        Unlike ``submit``, already-emitted tokens are PRESERVED. With a
        payload the request resumes exactly where it left off through
        the ordinary swap-in path: the payload parks in this instance's
        ``SwapArea`` and the scheduler admits it as a swapped waiting
        entry (``exec_swap_in`` re-allocates pages, uploads rows, and
        restores decode/prefill progress). Without one it replays
        prompt + emitted tokens through chunked prefill (exact under
        greedy decode) — the transfer-fault recompute fallback."""
        total = len(req.prompt) + req.max_tokens
        if req.max_len is not None:
            total = min(total, req.max_len)
        need = -(-total // self.backend.page_size)
        self.backend.check_capacity(req.rid, total, need)
        req.out = list(req.out or ())
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        if self.tel.enabled:
            self.tel.timeline(req.rid, sla=getattr(req, "sla", None))
            self.tel.recorder.record(
                "transfer_in", tick=self._tick_no, rid=req.rid,
                pages=len(payload["park"]) if payload else 0,
                recompute=payload is None)
        if payload is None:
            self.sched.submit(req)
            return
        assert not payload.get("kept"), \
            "transfer payloads must not carry device page ids"
        self.swap_area.put(req.rid, payload,
                           _rows_bytes(payload.get("rows")))
        self.sched.submit(req, swapped=True)

    # -- driver -------------------------------------------------------------

    def step(self) -> list[Request]:
        """One scheduler tick: admit / one-or-more prefill chunks / fused
        decode. Returns the requests that finished this step (normally or
        abnormally — check ``Request.finish_reason``). An exception that
        escapes the scheduler is ENGINE-level (per-request faults are
        contained inside the tick): the engine drains — every in-flight
        request fails terminally so no caller blocks forever — and then
        re-raises."""
        self._expire_deadlines()
        try:
            if not self.tel.enabled:
                fin = self.sched.tick(self)
            else:
                with self.tel.tracer.span("tick", n=self._tick_no):
                    fin = self.sched.tick(self)
        except Exception as e:
            self._drain(e)
            raise
        finally:
            self._tick_no += 1
        if self._terminal:
            fin = list(fin) + self._terminal
            self._terminal = []
        if self.tel.enabled:
            self._sync_metrics()
            if self.auditor.due(self._tick_no):
                self._run_audit()
        return fin

    def _drain(self, cause: BaseException) -> None:
        """Degraded-mode recovery from an engine-level failure: fail every
        in-flight and waiting request terminally (best effort — teardown
        errors are swallowed; the original ``cause`` is what propagates)
        so callers observe FAILED instead of hanging."""
        if self.tel.enabled:
            self.tel.recorder.record(
                "drain", tick=self._tick_no, error=repr(cause)[:200],
                n_active=len(self.active),
                n_waiting=len(self.sched.waiting))
            self.tel.metrics.counter(
                "engine_drains_total",
                "engine-level failures that drained all requests").inc()
        rids = [req.rid for req in self.active.values()]
        rids += [w.req.rid for w in self.sched.waiting]
        for rid in rids:
            try:
                self.cancel(rid, outcome="failed", reason="drain")
            except Exception:
                pass

    def _run_audit(self) -> None:
        """Sampled DLZS prediction audit: run the backend's exact-
        attention probe over one live decode sequence and fold the
        recall/score/skip-rate report (obs.audit). One extra decode-
        shaped dispatch per sample — never on the undecorated path."""
        slot = self.auditor.pick_slot(self._decode_slots())
        if slot is None:
            return
        rid = self.active[slot].rid
        with self.tel.tracer.span("audit", slot=slot, rid=rid):
            report = self.backend.audit_decode(
                slot, self.tables[slot], int(self.lengths[slot]))
        self.auditor.fold(report, self.tel.metrics, tick=self._tick_no,
                          rid=rid, recorder=self.tel.recorder)

    def _sync_metrics(self) -> None:
        """Fold scheduler stat deltas and pool occupancy into the
        registry (host-side state only; NO device syncs)."""
        reg = self.tel.metrics
        st = self.sched.stats
        for field in ("preemptions", "swap_outs", "recomputes",
                      "resumes", "sheds", "faults", "fault_retries",
                      "quarantines", "admission_sheds"):
            cur = getattr(st, field)
            delta = cur - self._sched_seen.get(field, 0)
            if delta > 0:
                reg.counter(f"engine_{field}_total",
                            f"scheduler {field}").inc(delta)
            self._sched_seen[field] = cur
        reg.counter("engine_ticks_total", "scheduler ticks").inc()
        bst = self.backend.stats()
        pool = bst.get("pool")
        if pool is not None:
            reg.gauge("engine_pool_pages_live",
                      "pool pages currently referenced").set(pool.live)
            reg.gauge("engine_pool_pages_capacity",
                      "pool page capacity").set(pool.capacity)
        pools = bst.get("pools")
        if isinstance(pools, dict) and "per_shard" in pools:
            for s, p in enumerate(pools["per_shard"]):
                live = p.live if hasattr(p, "live") else p["live"]
                cap = p.capacity if hasattr(p, "capacity") \
                    else p["capacity"]
                reg.gauge("engine_pool_pages_live",
                          "pool pages currently referenced").set(
                    live, shard=s)
                reg.gauge("engine_pool_pages_capacity",
                          "pool page capacity").set(cap, shard=s)
        if self.sched.budget_ctl is not None:
            reg.gauge("engine_prefill_budget_tokens",
                      "autotuned prefill token budget").set(
                self.sched.budget_ctl.budget)
        swap = self.swap_area.stats()
        reg.gauge("engine_swap_area_bytes",
                  "host bytes held by parked pages").set(swap.bytes)
        reg.gauge("engine_swap_area_entries",
                  "sequences parked on the host").set(swap.entries)

        # per-tick KV accounting + traffic deltas + the refcount watchdog
        snap = self.accounting_snapshot()
        fold_snapshot(reg, snap)
        q_events = snap["pool"].get("quantize_events", 0)
        dq = q_events - self._quant_seen
        if dq > 0:
            fold_traffic(reg, quantized_pages=dq,
                         page_bytes_int8=getattr(
                             self.backend, "page_bytes_int8", 0))
            self.tel.recorder.record("quant", tick=self._tick_no,
                                     pages=dq)
        self._quant_seen = q_events
        wd = reconcile_refs(self._expected_refs(),
                            self.backend.pool_refs())
        if not wd.ok:
            reg.counter(
                "engine_watchdog_violations_total",
                "pool refcounts the engine's tables and swap area "
                "cannot explain (leak / double-free in waiting)").inc(
                wd.violations)
            self.tel.recorder.record("watchdog", tick=self._tick_no,
                                     violations=wd.violations,
                                     detail=wd.describe()[:400])

    def dlzs_hot_fraction(self) -> Optional[float]:
        """Fraction of decode-phase live pages inside the DLZS hot set —
        a point-in-time snapshot for metrics() / the exposition endpoint.
        Pulls page scores from the device, so NEVER call per tick."""
        live = 0
        hot_n = 0
        for slot in self._decode_slots():
            table = self.tables.get(slot)
            if not table:
                continue
            hot = self.backend.hot_logical(table)
            for j, pid in enumerate(table):
                if pid is None or pid < 0:     # SHED sentinel
                    continue
                live += 1
                if j in hot:
                    hot_n += 1
        return round(hot_n / live, 4) if live else None

    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Serve a request list to completion; returns {rid: tokens}."""
        for r in requests:
            self.submit(r)
        done: dict[int, list] = {}
        steps = 0
        while self.sched.has_work() and steps < max_steps:
            for fin in self.step():
                done[fin.rid] = fin.out
            steps += 1
        return done

    # -- observability ------------------------------------------------------

    def accounting_snapshot(self) -> dict:
        """One tick's page-accounting census, from host state only.

        Every page the engine has allocated for a sequence is classified
        into exactly one of: **hot** (in the last decode step's bounded
        hot-set), **cold** (resident but not gathered), **shed** (SHED
        sentinel — content parked host-side while the sequence keeps
        decoding), or **swapped** (the whole sequence is parked), so
        ``allocated == hot + cold + shed + swapped`` holds at every tick
        boundary (obs.accounting.conservation_error). Pages of slots
        still mid-prefill (and decode slots the last decode step did not
        cover) count as cold. Fragmentation is the decode slots' tail
        slack: allocated-but-unwritten token positions over resident
        token capacity. No device syncs — block tables, the swap area
        and the backend's pool census are all host-side."""
        page = self.backend.page_size
        sparsity = getattr(self.backend, "decode_sparsity", None) or {}
        per_slot = sparsity.get("per_slot") or {}
        decoding = set(self._decode_slots())
        resident = shed = hot = 0
        token_slack = token_capacity = 0
        for slot, table in self.tables.items():
            res_slot = sum(1 for pid in table if pid >= 0)
            shed_slot = len(table) - res_slot
            resident += res_slot
            shed += shed_slot
            if slot in decoding:
                _, n_hot = per_slot.get(slot, (res_slot, 0))
                hot += min(n_hot, res_slot)
                on_device = int(self.lengths[slot]) - shed_slot * page
                token_capacity += res_slot * page
                token_slack += max(res_slot * page - on_device, 0)
        active_rids = {req.rid for req in self.active.values()}
        swapped = 0
        for rid, payload in self.swap_area.items():
            if rid in active_rids:
                continue   # lazy-shed payload: its pages ARE the shed
                #            sentinels above — counting both double-books
            swapped += payload.get("n_pages",
                                   len(payload.get("park", ())))
        return {
            "tick": self._tick_no,
            "pages": {"allocated": resident + shed + swapped,
                      "resident": resident, "hot": hot,
                      "cold": resident - hot, "shed": shed,
                      "swapped": swapped},
            "fragmentation": {
                "token_slack": token_slack,
                "token_capacity": token_capacity,
                "frac": round(token_slack / token_capacity, 6)
                if token_capacity else 0.0},
            "pool": self.backend.page_accounting(),
            "bytes": {
                "per_page_full": getattr(self.backend,
                                         "page_bytes_full", 0),
                "per_page_gather": getattr(self.backend,
                                           "page_bytes_gather", 0),
                "per_page_int8": getattr(self.backend,
                                         "page_bytes_int8", 0)},
        }

    def _expected_refs(self) -> dict:
        """(shard, pid) -> refcount the engine's state implies: one ref
        per live block-table entry plus one per swap-payload ``kept``
        entry (shared pages a fully-parked sequence still holds)."""
        expected: dict[tuple[int, int], int] = {}
        for table in self.tables.values():
            for j, pid in enumerate(table):
                if pid < 0:
                    continue
                key = (self.backend.owner_of(j), pid)
                expected[key] = expected.get(key, 0) + 1
        active_rids = {req.rid for req in self.active.values()}
        for rid, payload in self.swap_area.items():
            if rid in active_rids:
                continue               # lazy-shed payloads hold no refs
            for j, pid in payload.get("kept", ()):
                key = (self.backend.owner_of(j), pid)
                expected[key] = expected.get(key, 0) + 1
        return expected

    def stats(self) -> dict:
        st = self.backend.stats()
        st["swap"] = self.swap_area.stats()
        st["sched"] = dataclasses.replace(self.sched.stats)
        return st
