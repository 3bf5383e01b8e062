"""Per-tick KV-cache accounting: where every page is, in numbers.

``EngineCore.accounting_snapshot()`` assembles one host-side dict per
tick from facts the engine already holds (block tables, swap-area
payloads, the backend's refcount census) — this module turns it into
``MetricsRegistry`` series and checks two invariants:

* **conservation** — every page the engine has allocated for a sequence
  is exactly one of hot / cold (resident), shed (SHED sentinel, content
  parked host-side) or swapped (sequence fully parked):
  ``allocated == hot + cold + shed + swapped`` at every tick boundary.
  A drift means the engine's view of its tables and the swap area have
  diverged — exactly the class of bug page accounting exists to catch.
* **refcount reconciliation** (the watchdog) — the refcounts the pool
  holds must equal what the live tables + parked ``kept`` lists imply,
  per (shard, pid). A page the pool thinks is live that no table or park
  explains is a leak; a table entry the pool has already freed is a
  use-after-free in waiting.

Everything here is plain Python on small dicts — no torch, no device
syncs; the engine only calls in when telemetry is enabled.
"""

from __future__ import annotations

import dataclasses


def conservation_error(snap: dict) -> int:
    """``allocated - (hot + cold + shed + swapped)`` — 0 when the
    engine's page accounting balances."""
    p = snap["pages"]
    return p["allocated"] - (p["hot"] + p["cold"] + p["shed"]
                             + p["swapped"])


@dataclasses.dataclass
class WatchdogReport:
    """Refcount reconciliation result (see ``reconcile_refs``)."""

    mismatched: list  # (shard, pid, expected_refs, pool_refs)
    leaked: list      # (shard, pid, pool_refs) — pool ref nobody explains

    @property
    def ok(self) -> bool:
        return not (self.mismatched or self.leaked)

    @property
    def violations(self) -> int:
        return len(self.mismatched) + len(self.leaked)

    def describe(self) -> str:
        parts = [f"shard {s} pid {p}: expected {e} refs, pool holds {a}"
                 for s, p, e, a in self.mismatched]
        parts += [f"shard {s} pid {p}: pool holds {a} refs, "
                  f"no table/park references it"
                  for s, p, a in self.leaked]
        return "; ".join(parts) or "ok"


def reconcile_refs(expected: dict, pool_refs: dict) -> WatchdogReport:
    """Compare the engine-derived refcount map against the pool's.

    ``expected``: (shard, pid) -> refs implied by live block tables plus
    swap-area ``kept`` lists. ``pool_refs``: (shard, pid) -> the pool's
    actual refcount (live pages only). Prefix-cached pages sit at ref 0
    in the pool and appear in neither map.
    """
    mismatched = [(s, pid, e, pool_refs.get((s, pid), 0))
                  for (s, pid), e in sorted(expected.items())
                  if pool_refs.get((s, pid), 0) != e]
    leaked = [(s, pid, r) for (s, pid), r in sorted(pool_refs.items())
              if (s, pid) not in expected]
    return WatchdogReport(mismatched=mismatched, leaked=leaked)


def fold_snapshot(metrics, snap: dict) -> None:
    """Set the accounting gauges from one tick's snapshot."""
    pages = metrics.gauge(
        "engine_kv_pages",
        "engine page accounting by state (conservation: allocated == "
        "hot + cold + shed + swapped)")
    for state, v in snap["pages"].items():
        pages.set(v, state=state)

    pool = snap["pool"]
    occ = metrics.gauge(
        "engine_kv_pool_pages",
        "pool occupancy census: live pages by tier, plus "
        "shared/unique/cached/free breakdowns")
    occ.set(pool["live"] - pool["quantized_live"], tier="fp")
    occ.set(pool["quantized_live"], tier="int8")
    for kind in ("shared", "unique", "cached", "free"):
        occ.set(pool[kind], kind=kind)
    if pool.get("per_shard"):
        for row in pool["per_shard"]:
            occ.set(row["live"] - row["quantized_live"],
                    tier="fp", shard=row["shard"])
            occ.set(row["quantized_live"], tier="int8", shard=row["shard"])

    frag = snap["fragmentation"]
    metrics.gauge(
        "engine_kv_fragmentation_frac",
        "internal fragmentation: allocated-but-unwritten token slots / "
        "resident token capacity").set(frag["frac"])

    metrics.gauge(
        "engine_kv_conservation_error",
        "allocated - (hot+cold+shed+swapped); nonzero means the page "
        "accounting diverged").set(conservation_error(snap))


def fold_traffic(metrics, *, quantized_pages: int = 0,
                 page_bytes_int8: int = 0) -> None:
    """Fold per-tick traffic deltas the gauges can't express (counters).
    Swap/shed byte counters are incremented at the exec sites (they know
    the exact payload); quantize transitions are only visible as tracker
    deltas, priced here at the int8 tier's per-page bytes."""
    if quantized_pages:
        metrics.counter(
            "engine_pages_quantized_total",
            "pages transitioned fp -> int8 cold tier").inc(quantized_pages)
        metrics.counter(
            "engine_quantize_bytes_total",
            "bytes written into the int8 mirror tier by cold-page "
            "quantization").inc(quantized_pages * page_bytes_int8)
