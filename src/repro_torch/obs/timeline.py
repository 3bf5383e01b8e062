"""Per-request lifecycle timelines and latency aggregation.

A ``RequestTimeline`` records the host-clock epochs of one request's
life: submit -> admit -> first prefill chunk -> first token (TTFT) ->
per-token timestamps (TPOT) -> done/preempted/resumed. The engine stamps
these as the request moves through tick phases; ``serving.api``'s
``RequestRecord`` *is* a timeline (subclass), so handles expose the full
history for free.

``aggregate`` folds a set of timelines into p50/p95/p99 TTFT + TPOT and
per-SLA goodput; ``percentile`` is the shared linear-interpolation
helper (``LLM.metrics()`` and ``benchmarks/serving.py`` both use it).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(xs, q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default method), as a
    tiny host-side helper so metrics paths don't touch numpy arrays.

    Returns None for empty input; q is in [0, 100]."""
    xs = sorted(xs)
    if not xs:
        return None
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] + (xs[hi] - xs[lo]) * frac)


class RequestTimeline:
    """Host-clock epochs (``time.perf_counter()`` seconds) for one
    request. All stamps optional — a request may be shed before admit or
    finish at prefill with no decode tokens."""

    __slots__ = ("rid", "sla", "submit_t", "admit_t", "first_chunk_t",
                 "first_token_t", "done_t", "preempt_ts", "resume_ts",
                 "transfer_out_ts", "transfer_in_ts",
                 "token_ts", "n_tokens", "outcome")

    def __init__(self, rid: int, sla: Optional[str] = None,
                 submit_t: Optional[float] = None):
        self.rid = rid
        self.sla = sla
        self.submit_t = submit_t
        self.admit_t: Optional[float] = None
        self.first_chunk_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.preempt_ts: list[float] = []
        self.resume_ts: list[float] = []
        self.transfer_out_ts: list[float] = []   # left an instance (disagg
        #                                          handoff export staged)
        self.transfer_in_ts: list[float] = []    # adopted by the peer
        self.token_ts: list[float] = []
        self.n_tokens = 0
        self.outcome: Optional[str] = None
        # terminal state: "done" | "cancelled" | "expired" | "failed"
        # (legacy "preempted" appears in old dumps); None while in flight

    # -- derived ------------------------------------------------------------

    @property
    def ttft(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency(self) -> Optional[float]:
        if self.submit_t is None or self.done_t is None:
            return None
        return self.done_t - self.submit_t

    @property
    def tpots(self) -> list[float]:
        """Inter-token gaps (seconds). Includes the first-token -> second-
        token gap; empty when fewer than two decode timestamps exist."""
        ts = self.token_ts
        if self.first_token_t is not None:
            if not ts or ts[0] > self.first_token_t:
                ts = [self.first_token_t] + ts
        return [b - a for a, b in zip(ts, ts[1:])]

    def epochs(self) -> list[tuple[str, float]]:
        """The lifecycle as (event, t) pairs, time-sorted — what
        ``RequestHandle.timeline`` shows."""
        out = []
        for name in ("submit_t", "admit_t", "first_chunk_t",
                     "first_token_t", "done_t"):
            t = getattr(self, name)
            if t is not None:
                out.append((name[:-2], t))
        out.extend(("preempt", t) for t in self.preempt_ts)
        out.extend(("resume", t) for t in self.resume_ts)
        out.extend(("transfer_out", t) for t in self.transfer_out_ts)
        out.extend(("transfer_in", t) for t in self.transfer_in_ts)
        out.sort(key=lambda e: e[1])
        return out


def _dist_ms(xs) -> Optional[dict]:
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    return {"p50": round(1e3 * percentile(xs, 50), 3),
            "p95": round(1e3 * percentile(xs, 95), 3),
            "p99": round(1e3 * percentile(xs, 99), 3),
            "mean": round(1e3 * sum(xs) / len(xs), 3)}


def aggregate(timelines: Iterable[RequestTimeline]) -> dict:
    """Fold timelines into the latency surface ``LLM.metrics()`` reports:
    TTFT and TPOT distributions plus per-SLA request counts, mean TTFT,
    and goodput (completed tokens / span from first submit to last done
    within that SLA class)."""
    tls = list(timelines)
    ttfts = [t.ttft for t in tls]
    tpots = [g for t in tls for g in t.tpots]
    per_sla: dict[str, dict] = {}
    by_sla: dict[str, list[RequestTimeline]] = {}
    for t in tls:
        by_sla.setdefault(t.sla or "default", []).append(t)
    for sla, group in sorted(by_sla.items()):
        g_ttfts = [t.ttft for t in group if t.ttft is not None]
        done = [t for t in group if t.done_t is not None]
        # goodput is useful work only: tokens of requests that reached
        # the "done" outcome (cancelled/expired/failed tokens are waste)
        good = [t for t in done if t.outcome in (None, "done")]
        toks = sum(t.n_tokens for t in good)
        span = (max(t.done_t for t in done)
                - min(t.submit_t for t in done if t.submit_t is not None)
                ) if done and any(t.submit_t is not None for t in done) \
            else None
        outcomes: dict[str, int] = {}
        for t in done:
            o = t.outcome or "done"
            outcomes[o] = outcomes.get(o, 0) + 1
        per_sla[sla] = {
            "requests": len(group),
            "outcomes": outcomes,
            "deadline_miss_rate": round(
                outcomes.get("expired", 0) / len(group), 4)
            if group else None,
            "ttft_mean_ms": round(1e3 * sum(g_ttfts) / len(g_ttfts), 3)
            if g_ttfts else None,
            "goodput_tok_s": round(toks / span, 3)
            if span and span > 0 else None,
        }
    return {"requests": len(tls),
            "completed": sum(1 for t in tls if t.done_t is not None),
            "aborted": sum(1 for t in tls if t.outcome in
                           ("cancelled", "expired", "failed")),
            "preempted_requests": sum(1 for t in tls if t.preempt_ts),
            "ttft_ms": _dist_ms(ttfts),
            "tpot_ms": _dist_ms(tpots),
            "per_sla": per_sla}
