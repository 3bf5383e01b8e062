"""The serving front door of the port: ``LLM`` over the paged engine, the
sequence-sharded spatial engine or the dense slot oracle. PyTorch port of
``repro.serving.api``.

    llm = LLM.from_config(cfg, backend="paged")     # or "spatial"/"dense";
                                                    # cuda by default
    h = llm.submit(prompt, max_tokens=64, sla="interactive")
    for tok in h:                   # streams tokens, ticking the engine
        ...
    llm.run_until_done()            # or drive tick() yourself
    print(llm.metrics())            # TTFT / tok/s / occupancy / preempts

``LLM`` owns request ids, submit-time records and the serve loop;
``EngineCore`` owns slots, tables and the swap area; the backend
(``PagedBackend`` or ``spatial.SpatialBackend``) owns device state.
``backend="dense"`` serves the dense slot engine
(``serving.engine.ServingEngine``), the parity oracle.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from repro_torch import obs
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serving.engine import Request

BACKENDS = ("dense", "paged", "spatial")


def json_default(o):
    """``json.dump``'s fallback for the debug bundle's files: dataclasses
    as dicts, numpy and torch values as numbers (a tensor on any device
    as its values: its ``repr`` would carry no numbers a reader can load),
    sets sorted, anything else as its ``repr``."""
    import dataclasses

    import torch
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    if isinstance(o, (np.integer, np.floating, np.ndarray)):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return repr(o)


class RequestRecord(obs.RequestTimeline):
    """One request's lifecycle record: the ``obs.RequestTimeline`` the
    engine stamps, plus the request itself. ``LLM.records`` maps rid to
    these; handles read tokens and timing through them."""

    __slots__ = ("req",)

    def __init__(self, req: Request, submit_t: float):
        super().__init__(req.rid, sla=req.sla, submit_t=submit_t)
        self.req = req


class RequestHandle:
    """One submitted request: stream its tokens or wait for the result.

    Iterating the handle yields generated tokens as they appear,
    driving ``llm.tick()`` whenever none are buffered — so a plain
    ``for tok in handle`` serves the whole engine (co-resident requests
    included) while streaming this one."""

    def __init__(self, llm: "LLM", rid: int):
        self._llm = llm
        self.rid = rid

    @property
    def _record(self) -> RequestRecord:
        return self._llm.records[self.rid]

    @property
    def tokens(self) -> list[int]:
        """Tokens generated so far."""
        return list(self._record.req.out or ())

    @property
    def done(self) -> bool:
        return self._record.done_t is not None

    @property
    def ttft_s(self) -> Optional[float]:
        return self._record.ttft

    @property
    def outcome(self) -> Optional[str]:
        """Terminal state: "done" | "cancelled" | "expired" | "failed";
        None while in flight."""
        rec = self._record
        return rec.outcome or getattr(rec.req, "finish_reason", None)

    @property
    def timeline(self) -> obs.RequestTimeline:
        """The request's lifecycle timeline (``.epochs()`` for the
        time-sorted event list, ``.tpots`` for inter-token gaps)."""
        return self._record

    def cancel(self, reason: str = "client") -> bool:
        """Terminate this request wherever it is (queued, prefilling,
        decoding, or swapped out); already-terminal requests return
        False. Tokens generated so far stay readable."""
        return self._llm.cancel(self.rid, reason=reason)

    def __iter__(self) -> Iterator[int]:
        sent = 0
        while True:
            out = self._record.req.out or ()
            while sent < len(out):
                yield int(out[sent])
                sent += 1
            if self.done:
                return
            if not self._llm.has_work():     # defensive: nothing can move
                return
            self._llm.tick()

    def result(self, max_steps: int = 100_000) -> list[int]:
        """Drive the engine until this request finishes; returns its
        tokens (other requests keep being served along the way)."""
        steps = 0
        while not self.done and self._llm.has_work() and steps < max_steps:
            self._llm.tick()
            steps += 1
        return self.tokens


class LLM:
    """Front-door serving interface over a constructed engine.

    Use ``LLM.from_config`` to build engine + backend in one call, or
    pass any engine exposing ``submit / step / queue / active``
    (``PagedServingEngine``, ``SpatialServingEngine``, the dense
    ``ServingEngine``)."""

    def __init__(self, engine, telemetry=None):
        self.engine = engine
        if telemetry is not None and hasattr(engine, "attach_telemetry"):
            engine.attach_telemetry(telemetry)
        self.tel = telemetry or getattr(engine, "tel", None) \
            or NULL_TELEMETRY
        self.records: dict[int, RequestRecord] = {}
        self._pending: dict[int, RequestRecord] = {}   # not yet finished:
        #                         the only records a tick has to touch, so
        #                         a long-lived serve loop stays O(active)
        #                         per tick, not O(all-time requests)
        self._next_rid = 0
        # the dense slot engine predates the scheduler protocol: its tick
        # is an explicit admit() + generator-style step()
        self._dense = not hasattr(engine, "sched")

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, model_cfg, *, backend: str = "paged",
                    params=None, shards: int = 2, engine_cfg=None,
                    sched_cfg=None,
                    generator: Optional["torch.Generator"] = None,
                    device=None, telemetry=None,
                    audit_cfg=None) -> "LLM":
        """Build params (if not given), the backend engine, and the LLM.

        ``backend="paged"`` is the single page pool (``PagedEngineCfg``),
        ``"spatial"`` the sequence-sharded engine (``SpatialEngineCfg``,
        default ``n_shards=shards``; every shard on ``device``; the model
        must have ``star=None``), ``"dense"`` the dense slot oracle
        (``EngineCfg``; ``sched_cfg`` and ``audit_cfg`` do not apply to
        it).
        ``device`` defaults to ``cuda`` and raises without a GPU; the
        tests pass ``device="cpu"``. ``generator`` (default: one seeded
        with 0 on the device) draws the random weights when
        ``params`` is None and then drives sampled decode. ``sched_cfg``
        defaults to the batched prefill with the ``prefill_tokens="auto"``
        budget controller; ``kv_quant="int8"`` adds the int8 cold tier.
        ``telemetry`` (an ``obs.Telemetry``) enables tracing + metrics;
        ``audit_cfg`` tunes the sampled DLZS prediction audit.
        """
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.models import lm
        from repro_torch.serving.engine import EngineCfg, ServingEngine
        from repro_torch.serving.paged import (PagedEngineCfg,
                                               PagedServingEngine)
        from repro_torch.serving.scheduler import SchedulerCfg

        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}: choose from {BACKENDS}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        if params is None:
            params = lm.init(model_cfg, generator, dev)
        if backend == "dense":
            eng = ServingEngine(model_cfg, params, engine_cfg or EngineCfg(),
                                generator=generator)
            return cls(eng, telemetry=telemetry)
        scfg = sched_cfg or SchedulerCfg(prefill_tokens="auto")
        if backend == "paged":
            eng = PagedServingEngine(model_cfg, params,
                                     engine_cfg or PagedEngineCfg(), scfg,
                                     generator=generator)
        else:
            from repro_torch.spatial.engine import (SpatialEngineCfg,
                                                    SpatialServingEngine)
            eng = SpatialServingEngine(
                model_cfg, params,
                engine_cfg or SpatialEngineCfg(n_shards=shards), scfg,
                generator=generator)
        if audit_cfg is not None:
            eng.auditor = obs.DlzsAuditor(audit_cfg)
        return cls(eng, telemetry=telemetry)

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_tokens: int = 32, *,
               sla: Optional[str] = None, priority: Optional[int] = None,
               max_len: Optional[int] = None, rid: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               ttft_deadline_ms: Optional[float] = None
               ) -> RequestHandle:
        """Queue one request; returns its handle. ``sla`` is the QoS
        input — the scheduler maps it to a priority at submit (an
        explicit ``priority`` wins). ``deadline_ms`` /
        ``ttft_deadline_ms`` bound end-to-end and first-token latency;
        a lapsed budget makes the request terminal with outcome
        "expired" (with ``SchedulerCfg.sla_deadlines`` the SLA class
        fills unset budgets from ``SLA_DEADLINES_MS``)."""
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_tokens=max_tokens, max_len=max_len,
                      sla=None if priority is not None else sla,
                      priority=priority or 0,
                      deadline_ms=deadline_ms,
                      ttft_deadline_ms=ttft_deadline_ms)
        rec = RequestRecord(req, time.perf_counter())
        if self.tel.enabled:
            # pre-register so the engine's timeline(rid) lookups stamp
            # THIS record (record and timeline are one object)
            self.tel.timelines[rid] = rec
        try:
            # submit before keeping the record: a capacity rejection
            # (ValueError) must not leave a phantom never-finishing
            # record behind in a long-lived server
            self._submit_engine(req)
        except Exception:
            if self.tel.enabled:
                self.tel.timelines.pop(rid, None)
            raise
        self.records[rid] = rec
        self._pending[rid] = rec
        return RequestHandle(self, rid)

    # -- the serve loop ------------------------------------------------------

    # The three engine touch-points below are the subclass seam: the
    # disaggregated router (serving/disagg) overrides them to route
    # submits to a prefill instance, step both instances with a KV
    # handoff in between, and cancel across instances — while tick()'s
    # record stamping and submit()'s rollback discipline stay shared.

    def _submit_engine(self, req: Request) -> None:
        self.engine.submit(req)

    def _cancel_engine(self, rid: int, *, reason: str) -> bool:
        return self.engine.cancel(rid, reason=reason)

    def _step_engines(self) -> list[Request]:
        if self._dense:
            span = self.tel.tracer.span("tick")
            with span:
                self.engine.admit()
                finished = list(self.engine.step() or ())
            finished += self.engine.drain_terminal()
            return finished
        # core engines trace their own tick span inside step() and
        # fold abnormal terminals into the finished list themselves
        return self.engine.step() or []

    def tick(self) -> list[Request]:
        """One engine step; stamps TTFT / completion times."""
        finished = self._step_engines()
        now = time.perf_counter()
        for rec in self._pending.values():
            if rec.first_token_t is None and rec.req.out:
                rec.first_token_t = now
        for fin in finished:
            # cancel() may have closed the record already
            rec = self._pending.pop(fin.rid, None)
            if rec is None:
                continue
            if rec.done_t is None:      # engine telemetry may have stamped
                rec.done_t = now
            rec.n_tokens = len(fin.out or ())
            if rec.outcome is None:
                rec.outcome = getattr(fin, "finish_reason", None) or "done"
        return finished

    def cancel(self, rid: int, *, reason: str = "client") -> bool:
        """Terminate a request by id; closes its record immediately (the
        engine also reports it terminal on the next tick, which is a
        no-op here). Returns False for unknown / already-terminal rids."""
        rec = self._pending.get(rid)
        if rec is None or not self._cancel_engine(rid, reason=reason):
            return False
        self._pending.pop(rid, None)
        if rec.done_t is None:
            rec.done_t = time.perf_counter()
        rec.n_tokens = len(rec.req.out or ())
        if rec.outcome is None:
            rec.outcome = rec.req.finish_reason or "cancelled"
        return True

    def has_work(self) -> bool:
        return bool(self.engine.queue or self.engine.active
                    or getattr(self.engine, "_terminal", ()))

    def run_until_done(self, max_steps: int = 100_000) -> dict[int, list]:
        """Drain every queued request; returns {rid: tokens}."""
        done: dict[int, list] = {}
        steps = 0
        while self.has_work() and steps < max_steps:
            for fin in self.tick():
                done[fin.rid] = fin.out
            steps += 1
        return done

    # kept as the pre-LLM entry-point name some callers still use
    run = run_until_done

    def clear_finished(self) -> None:
        """Drop finished records (typically after ``metrics()``) so a
        persistent server's history does not grow without bound."""
        self.records = {rid: rec for rid, rec in self.records.items()
                        if rec.done_t is None}
        if self.tel.enabled:
            self.tel.timelines = {
                rid: tl for rid, tl in self.tel.timelines.items()
                if tl.done_t is None}

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        return self.engine.stats() if hasattr(self.engine, "stats") else {}

    def debug_bundle(self, out_dir: Optional[str] = None) -> str:
        """Dump the serving post-mortem bundle to ``out_dir`` (default
        ``./debug_bundle``): the flight-recorder ring (recorder.jsonl),
        the tick-phase trace (trace.json, Perfetto/chrome format), the
        metrics registry (metrics.json + metrics.prom), the latest page-
        accounting census (accounting.json), retained audit reports
        (audit.json), timeline aggregates (timelines.json) and the
        engine/scheduler config (config.json). Returns the directory.
        Works with telemetry disabled too — the bundle just carries
        empty rings and registries."""
        import json
        import os

        out = out_dir or "debug_bundle"
        os.makedirs(out, exist_ok=True)

        def dump(name, obj):
            with open(os.path.join(out, name), "w") as f:
                json.dump(obj, f, indent=2, default=json_default)
                f.write("\n")

        eng = self.engine
        with open(os.path.join(out, "recorder.jsonl"), "w") as f:
            f.write(self.tel.recorder.to_jsonl())
        if hasattr(self.tel.tracer, "export_chrome"):
            self.tel.tracer.export_chrome(os.path.join(out, "trace.json"))
        dump("metrics.json", self.tel.metrics.snapshot())
        with open(os.path.join(out, "metrics.prom"), "w") as f:
            f.write(self.tel.metrics.render_prometheus())
        if hasattr(eng, "accounting_snapshot"):
            dump("accounting.json", eng.accounting_snapshot())
        if hasattr(eng, "auditor"):
            dump("audit.json", {
                "cfg": eng.auditor.cfg,
                "runs": eng.auditor.runs,
                "skipped": eng.auditor.skipped,
                "reports": list(eng.auditor.reports)})
        dump("timelines.json", self.tel.aggregate())
        backend = getattr(eng, "backend", eng)
        dump("config.json", {
            "engine": type(eng).__name__,
            "backend": type(backend).__name__,
            "model_cfg": getattr(backend, "cfg", None),
            "engine_cfg": getattr(backend, "pcfg", None),
            "sched_cfg": getattr(getattr(eng, "sched", None), "cfg", None),
            "recorder": {"capacity": self.tel.recorder.capacity,
                         "retained": len(self.tel.recorder),
                         "dropped": self.tel.recorder.dropped},
        })
        return out

    def metrics(self) -> dict:
        """Serving snapshot: request/token counts, wall time, tok/s,
        TTFT/TPOT percentiles (``obs.percentile``, linear interpolation),
        per-SLA TTFT + goodput, pool occupancy and preemption counters —
        everything the launchers and benchmarks report. With live
        telemetry the registry snapshot rides along under ``counters``."""
        st = self.stats()
        occupancy = None
        pool = st.get("pool") or st.get("pools")
        if pool is not None:
            live = pool.live if hasattr(pool, "live") else pool["live"]
            cap = pool.capacity if hasattr(pool, "capacity") \
                else pool["capacity"]
            occupancy = round(live / max(cap, 1), 4)
        sched = st.get("sched")
        out = {
            "occupancy": occupancy,
            "preemptions": getattr(sched, "preemptions", 0),
            "sheds": getattr(sched, "sheds", 0),
            "resumes": getattr(sched, "resumes", 0),
            "engine": st,
        }
        if self.tel.enabled:
            out["counters"] = self.tel.metrics.snapshot()
            if hasattr(self.engine, "dlzs_hot_fraction"):
                # point-in-time snapshot (device sync — metrics() is an
                # endpoint call, never the hot path)
                out["dlzs_hot_fraction"] = self.engine.dlzs_hot_fraction()
        recs = [r for r in self.records.values() if r.done_t is not None]
        if not recs:
            out["requests"] = 0
            return out
        t0 = min(r.submit_t for r in recs)
        t1 = max(r.done_t for r in recs)
        n_tok = sum(len(r.req.out) for r in recs)
        ttfts = [r.ttft for r in recs if r.ttft is not None]
        tpots = [g for r in recs for g in r.tpots]
        if not tpots:
            # telemetry off: no per-token stamps — approximate each
            # request's TPOT by its decode-time mean
            for r in recs:
                n = len(r.req.out or ())
                if n > 1 and r.ttft is not None and r.latency is not None:
                    tpots.append((r.latency - r.ttft) / (n - 1))
        by_sla: dict[str, list] = {}
        for r in recs:
            by_sla.setdefault(r.req.sla or "default", []).append(r)

        def pct_ms(xs, q):
            v = obs.percentile(xs, q)
            return None if v is None else round(1e3 * v, 2)

        per_sla = {}
        for k, v in sorted(by_sla.items()):
            # goodput counts only work that completed within its budgets:
            # tokens of cancelled/expired/failed requests were wasted
            ok = [r for r in v if (r.outcome or "done") == "done"]
            g_ttfts = [r.ttft for r in ok if r.ttft is not None]
            g_tok = sum(len(r.req.out or ()) for r in ok)
            g_span = max(r.done_t for r in v) - min(r.submit_t for r in v)
            outcomes: dict[str, int] = {}
            for r in v:
                o = r.outcome or "done"
                outcomes[o] = outcomes.get(o, 0) + 1
            per_sla[k] = {
                "requests": len(v),
                "outcomes": outcomes,
                "deadline_miss_rate": round(
                    outcomes.get("expired", 0) / len(v), 4),
                "ttft_mean_ms": round(
                    1e3 * sum(g_ttfts) / len(g_ttfts), 1)
                if g_ttfts else None,
                "goodput_tok_s": round(g_tok / g_span, 1)
                if g_span > 0 else None,
            }
        out.update({
            "requests": len(recs),
            "tokens": n_tok,
            "wall_s": round(t1 - t0, 4),
            "tok_s": round(n_tok / max(t1 - t0, 1e-9), 1),
            "ttft_p50_ms": pct_ms(ttfts, 50),
            "ttft_p95_ms": pct_ms(ttfts, 95),
            "ttft_p99_ms": pct_ms(ttfts, 99),
            "ttft_mean_ms": round(1e3 * sum(ttfts) / len(ttfts), 1)
            if ttfts else None,
            "tpot_p50_ms": pct_ms(tpots, 50),
            "tpot_p95_ms": pct_ms(tpots, 95),
            "tpot_p99_ms": pct_ms(tpots, 99),
            "per_sla": per_sla,
        })
        return out
