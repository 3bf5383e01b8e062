"""Serving telemetry: tracing, metrics, and request timelines.

One ``Telemetry`` object bundles the three surfaces the engine stack
shares:

* ``tel.tracer`` — span/instant trace events per tick phase, exportable
  as Perfetto/Chrome ``trace_event`` JSON (see ``obs.trace``);
* ``tel.metrics`` — a ``MetricsRegistry`` of counters/gauges/histograms
  with per-SLA / per-shard labels and Prometheus text exposition;
* ``tel.timelines`` — per-request ``RequestTimeline`` lifecycles
  (submit → admit → TTFT → per-token → done/preempted).

The default everywhere is ``NULL_TELEMETRY`` — a disabled instance whose
tracer is a no-op and whose ``enabled`` flag guards every hot-path
write, so serving without telemetry costs a few attribute checks per
tick (asserted <5% overhead in tests/test_obs.py). Enable by passing a
real ``Telemetry()`` to ``LLM.from_config(..., telemetry=...)`` or
``EngineCore.attach_telemetry``. Nothing in this package touches torch:
all events are host-side; no device syncs are added to the hot path.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.accounting import (WatchdogReport, conservation_error,
                                  fold_snapshot, fold_traffic,
                                  reconcile_refs)
from repro_torch.obs.audit import AuditCfg, DlzsAuditor, score_histogram
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               DEFAULT_BUCKETS)
from repro_torch.obs.recorder import NULL_RECORDER, FlightRecorder
from repro_torch.obs.timeline import RequestTimeline, aggregate, percentile
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer, format_table,
                             load_trace, phase_summary)


class Telemetry:
    """Live telemetry: a tracer, a metrics registry, and the per-request
    timeline table, sharing one identity the whole stack can hold."""

    enabled = True

    def __init__(self, meta: Optional[dict] = None,
                 recorder_capacity: int = 1024):
        self.meta = dict(meta or {})
        self.tracer = Tracer(self.meta)
        self.metrics = MetricsRegistry()
        self.timelines: dict[int, RequestTimeline] = {}
        self.recorder = FlightRecorder(capacity=recorder_capacity)

    def timeline(self, rid: int, sla: Optional[str] = None,
                 submit_t: Optional[float] = None) -> RequestTimeline:
        """Get-or-create the request's timeline; backfills sla/submit_t
        when first provided (the engine may see the rid before the API
        layer has registered its record)."""
        tl = self.timelines.get(rid)
        if tl is None:
            tl = RequestTimeline(rid, sla=sla,
                                 submit_t=submit_t
                                 if submit_t is not None
                                 else time.perf_counter())
            self.timelines[rid] = tl
        else:
            if tl.sla is None and sla is not None:
                tl.sla = sla
            if tl.submit_t is None and submit_t is not None:
                tl.submit_t = submit_t
        return tl

    def aggregate(self) -> dict:
        return aggregate(self.timelines.values())


class NullTelemetry(Telemetry):
    """Disabled telemetry: tracer is the shared no-op, timelines are
    throwaway objects nobody retains. ``enabled`` is False — hot paths
    check that one flag and skip all event construction."""

    enabled = False

    def __init__(self):
        super().__init__()
        self.tracer = NULL_TRACER
        self.recorder = NULL_RECORDER   # capacity-0 ring: drops everything

    def timeline(self, rid: int, sla: Optional[str] = None,
                 submit_t: Optional[float] = None) -> RequestTimeline:
        # fresh throwaway: stamps on a disabled timeline go nowhere,
        # and the table never grows
        return RequestTimeline(rid, sla=sla, submit_t=submit_t)


NULL_TELEMETRY = NullTelemetry()

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "RequestTimeline", "aggregate", "percentile",
    "Tracer", "NullTracer", "NULL_TRACER", "load_trace", "phase_summary",
    "format_table",
    "FlightRecorder", "NULL_RECORDER",
    "AuditCfg", "DlzsAuditor", "score_histogram",
    "WatchdogReport", "conservation_error", "fold_snapshot",
    "fold_traffic", "reconcile_refs",
    "Telemetry", "NullTelemetry", "NULL_TELEMETRY",
]
