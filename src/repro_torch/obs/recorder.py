"""Engine flight recorder: a bounded ring of scheduling decisions.

Counters say *how often* the engine preempted; the recorder says *what it
did, in order*: every admit, preempt, shed, swap-in, quantize transition,
hot-set change and watchdog violation lands here as one small host-side
dict, in a ``deque(maxlen=capacity)`` so memory is bounded no matter how
long the engine runs. ``LLM.debug_bundle()`` dumps the ring next to the
trace/metrics/config for post-mortems — the last N decisions before a
stall or a quality regression are usually the whole story.

Events carry a monotonically increasing ``seq`` so drops are visible:
``recorder.dropped`` is how many events fell off the front of the ring.
Everything here is plain Python (no torch, no device syncs); hot paths only
call ``record`` behind the telemetry ``enabled`` flag.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Optional


class FlightRecorder:
    """Bounded ring buffer of engine decision events."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._seq = 0
        self._events: collections.deque = collections.deque(
            maxlen=max(0, capacity))

    def record(self, kind: str, **fields) -> None:
        """Append one event. ``kind`` is the decision type (admit /
        preempt / shed / swap_in / quant / hot_set / watchdog / audit,
        plus the lifecycle/fault kinds: cancel / deadline_expired /
        fault / fault_injected / retry / quarantine / drain — see
        docs/observability.md); ``fields`` are small JSON-serializable
        scalars."""
        if self._events.maxlen == 0:
            return
        self._seq += 1
        self._events.append({"seq": self._seq,
                             "t": round(time.perf_counter(), 6),
                             "kind": kind, **fields})

    def events(self, kind: Optional[str] = None) -> list[dict]:
        """Retained events oldest-first, optionally filtered by kind."""
        return [dict(e) for e in self._events
                if kind is None or e["kind"] == kind]

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events that fell off the front of the ring."""
        return self._seq - len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_jsonl(self) -> str:
        """One JSON object per line, oldest-first (the debug-bundle
        format; ``json.loads`` per line round-trips)."""
        return "".join(json.dumps(e) + "\n" for e in self._events)


# shared no-op ring for NullTelemetry: capacity 0 drops everything
NULL_RECORDER = FlightRecorder(capacity=0)
