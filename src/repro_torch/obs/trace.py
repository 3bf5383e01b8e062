"""Host-side tracing: Perfetto/Chrome ``trace_event`` spans for ticks.

A ``Tracer`` collects structured span ("X" complete) and instant ("i")
events with microsecond timestamps relative to construction. Everything
is host-side — no device syncs, no torch imports — so enabling a trace
never perturbs the engine's dispatch behavior, and the disabled path
(``NullTracer``) is a handful of no-op calls per tick.

Exports:

* ``Tracer.export_chrome(path)`` — a ``{"traceEvents": [...]}`` JSON
  Chrome/Perfetto loads directly (chrome://tracing, ui.perfetto.dev).
* ``Tracer.export_jsonl(path)`` — one event per line (streamable); a
  leading ``{"meta": ...}`` header line carries run metadata.
* ``load_trace(path)`` — round-trip loader for both formats.
* ``phase_summary(events)`` — the per-phase time table ``tools/
  trace_summary.py`` and ``benchmarks/serving.py`` (phase_breakdown)
  share: per-tick ms in admit/prefill/decode/swap plus the host
  remainder (tick time not inside any phase span).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class _NullSpan:
    """Shared no-op context manager the disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    @property
    def args(self) -> dict:
        # fresh throwaway: annotations on a disabled span go nowhere
        return {}


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op returning shared objects.

    ``enabled`` is the guard hot paths check before building event
    arguments; span()/instant() still exist so cold paths can skip the
    guard entirely."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, tid: int = 0, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, tid: int = 0, **args) -> None:
        return None

    def name_track(self, tid: int, name: str) -> None:
        return None

    def clear(self) -> None:
        return None

    @property
    def events(self) -> list:
        return []


NULL_TRACER = NullTracer()


class _Span:
    """One open span; emits a complete ("X") event when it exits.

    ``args`` is mutable until exit, so callers can annotate outcomes
    discovered mid-span (pages freed, wave splits, ...)."""

    __slots__ = ("_tr", "name", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tid: int, args: dict):
        self._tr = tracer
        self.name = name
        self.tid = tid
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self._tr._complete(self.name, self.tid, self._t0,
                           time.perf_counter(), self.args)
        return False


class Tracer:
    """Collects trace events in memory; export when the run is over.

    Timestamps are ``time.perf_counter()`` relative to construction, in
    microseconds (the trace_event unit). ``tid`` maps to a Perfetto
    track — 0 is the engine tick track; backends may use shard ids."""

    enabled = True

    def __init__(self, meta: Optional[dict] = None):
        self.meta = dict(meta or {})
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._track_names: dict[int, str] = {}

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    # -- emission -----------------------------------------------------------

    def span(self, name: str, tid: int = 0, **args) -> _Span:
        """Open a span; use as a context manager."""
        return _Span(self, name, tid, args)

    def _complete(self, name: str, tid: int, t0: float, t1: float,
                  args: dict) -> None:
        ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
              "ts": self._us(t0), "dur": round((t1 - t0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int = 0, **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "pid": 0, "tid": tid,
              "ts": self._us(time.perf_counter())}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def name_track(self, tid: int, name: str) -> None:
        self._track_names[tid] = name

    def clear(self) -> None:
        """Drop collected events (e.g. after a warmup pass). The time
        origin is kept so timestamps stay monotonic across clears."""
        self.events = []

    # -- export -------------------------------------------------------------

    def _metadata_events(self) -> list[dict]:
        out = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": self.meta.get("backend", "engine")}}]
        for tid, name in sorted(self._track_names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        return out

    def chrome_trace(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON document."""
        return {"traceEvents": self._metadata_events() + self.events,
                "displayTimeUnit": "ms",
                "otherData": self.meta}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"meta": self.meta}) + "\n")
            for ev in self._metadata_events() + self.events:
                f.write(json.dumps(ev) + "\n")


def load_trace(path: str) -> list[dict]:
    """Load events back from either export format (round-trip)."""
    if path.endswith(".jsonl"):
        events = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                if "ph" in doc:
                    events.append(doc)
        return events
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


# scheduler phase spans -> phase_summary buckets
_PHASES = {"phase.admit": "admit", "phase.prefill": "prefill",
           "phase.decode": "decode"}
# swap activity spans (nested INSIDE prefill/decode phases — reported as
# its own bucket but not subtracted from them)
_SWAP = {"preempt", "swap_in", "shed"}


def phase_summary(events: list[dict]) -> dict:
    """Where tick time goes: totals and per-tick ms by phase.

    ``host`` is the tick-span remainder outside every scheduler phase —
    bookkeeping, packing, python overhead. ``swap`` sums preempt /
    swap-in / shed spans (they nest inside prefill/decode phases, so
    swap + the three phases can exceed the tick total). ``compile_ms``
    sums spans flagged as first-call dispatches."""
    sums = {"admit": 0.0, "prefill": 0.0, "decode": 0.0, "swap": 0.0}
    counts = {"admit": 0, "prefill": 0, "decode": 0, "swap": 0}
    ticks = 0
    tick_ms = 0.0
    compile_ms = 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        if name == "tick":
            ticks += 1
            tick_ms += dur_ms
            continue
        key = _PHASES.get(name)
        if key is None and name in _SWAP:
            key = "swap"
        if key is not None:
            sums[key] += dur_ms
            counts[key] += 1
        if (ev.get("args") or {}).get("compile"):
            compile_ms += dur_ms
    host = max(0.0, tick_ms - sums["admit"] - sums["prefill"]
               - sums["decode"])
    totals = {k: round(v, 3) for k, v in sums.items()}
    totals["host"] = round(host, 3)
    n = max(ticks, 1)
    per_tick = {k: round(v / n, 4) for k, v in sums.items()}
    per_tick["host"] = round(host / n, 4)
    return {"ticks": ticks,
            "wall_ms": round(tick_ms, 3),
            "totals_ms": totals,
            "per_tick_ms": per_tick,
            "counts": counts,
            "compile_ms": round(compile_ms, 3)}


def format_table(summary: dict, title: str = "") -> str:
    """Render a ``phase_summary`` dict as the per-phase time table
    printed by ``tools/trace_summary.py`` and the traced launchers."""
    head = f"trace_summary{f'[{title}]' if title else ''}: " \
           f"{summary['ticks']} ticks, {summary['wall_ms']:.1f}ms wall, " \
           f"{summary['compile_ms']:.1f}ms in first-call dispatches"
    rows = [head,
            f"  {'phase':<10}{'total ms':>12}{'per-tick ms':>14}"
            f"{'spans':>8}"]
    counts = summary.get("counts", {})
    for key in ("admit", "prefill", "decode", "swap", "host"):
        rows.append(
            f"  {key:<10}{summary['totals_ms'][key]:>12.2f}"
            f"{summary['per_tick_ms'][key]:>14.4f}"
            f"{counts.get(key, ''):>8}")
    return "\n".join(rows)
