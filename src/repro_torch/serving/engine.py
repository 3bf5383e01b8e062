"""The live request type shared by every engine of the port.

``repro.serving.engine`` also holds the retired dense slot engine, the
serving parity oracle; that engine is a later slice of the port (ROADMAP
§1 item 6) — until then the reference's serves as the oracle in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_tokens: int = 32
    max_len: Optional[int] = None   # per-request total-length cap (paged
    #                                 engine; the dense engine's cap is the
    #                                 engine-wide EngineCfg.max_len)
    priority: int = 0           # higher = more important: admitted first,
    #                             preempted last under pool pressure (paged
    #                             engine scheduler; ties break by arrival)
    sla: Optional[str] = None   # QoS class ("interactive" | "standard" |
    #                             "batch"); when set the scheduler maps it
    #                             onto ``priority`` at submit
    out: Optional[list] = None
    deadline_ms: Optional[float] = None      # end-to-end budget from
    #                             submit; exceeded -> EXPIRED terminal
    ttft_deadline_ms: Optional[float] = None  # first-token budget; only
    #                             checked while no token has been emitted
    submit_t: Optional[float] = None  # perf_counter at engine submit —
    #                             the clock deadlines measure against
    finish_reason: Optional[str] = None
    # terminal state: "done" | "cancelled" | "expired" | "failed";
    # None while in flight (docs/serving.md lifecycle state machine)

    def deadline_exceeded(self, now: float) -> bool:
        """Has either budget lapsed at wall-clock ``now``?"""
        if self.submit_t is None:
            return False
        waited_ms = (now - self.submit_t) * 1e3
        if self.deadline_ms is not None and waited_ms > self.deadline_ms:
            return True
        return (self.ttft_deadline_ms is not None and not self.out
                and waited_ms > self.ttft_deadline_ms)
