"""Sampled DLZS prediction-quality audit: does the hot set hold the mass?

The decode path trusts the sphere rule over per-page DLZS scores to pick
which pages are worth gathering. This module measures that trust: every
``every_ticks`` ticks (telemetry enabled only — the sampler is never
consulted otherwise) the engine runs the backend's exact-attention probe
over ONE live decode sequence's full resident page set
(``backend.audit_decode`` -> ``kvcache.paged_attention
.page_attention_mass``) and this module folds the result:

* **attention-mass recall** — the fraction of the next query's softmax
  mass that falls on the sphere-selected hot pages, per layer. 1.0 when
  ``decode_hot_width=None`` (everything resident is hot) — the
  correctness anchor tests pin; under bounded widths this is the live
  version of the recall curves LAPA/SOFA evaluate their predictors by.
* **per-layer DLZS score histograms** — how the |LZ code| page scores
  the predictor ranks by are distributed across the stack.
* **per-shard skip rates** (spatial) — how often the bounded hot set
  leaves a shard with nothing to contribute, per shard.

The auditor itself is plain Python: sampling policy, report folding, a
bounded ring of retained reports. The device-touching probe lives in the
backends — nothing in ``repro_torch.obs`` imports torch.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

RECALL_BUCKETS = (0.5, 0.8, 0.9, 0.95, 0.99, 0.999, 1.0)


@dataclasses.dataclass(frozen=True)
class AuditCfg:
    """Sampling knobs. ``every_ticks <= 0`` disables the auditor even
    with telemetry on (the probe costs one extra decode-shaped dispatch
    per sample)."""

    every_ticks: int = 32     # sample one sequence every N engine ticks
    max_reports: int = 64     # retained report ring (debug bundle size)
    score_bins: int = 8       # per-layer DLZS score histogram bins


def score_histogram(scores_per_layer, bins: int = 8) -> Optional[dict]:
    """Bin per-(layer, page) DLZS scores into ``bins`` integer-edged
    buckets over the observed range. Returns {"edges": [...], "counts":
    [[...] per layer]} or None without an LZ slab."""
    if not scores_per_layer:
        return None
    lo = min(min(row) for row in scores_per_layer if row)
    hi = max(max(row) for row in scores_per_layer if row)
    span = max(hi - lo, 1)
    step = max(1, -(-span // bins))                # ceil div, integer edges
    edges = [lo + i * step for i in range(bins + 1)]
    counts = []
    for row in scores_per_layer:
        c = [0] * bins
        for v in row:
            c[min(int((v - lo) // step), bins - 1)] += 1
        counts.append(c)
    return {"edges": edges, "counts": counts}


class DlzsAuditor:
    """Sampling policy + report folding for the exact-attention audit."""

    def __init__(self, cfg: Optional[AuditCfg] = None):
        self.cfg = cfg or AuditCfg()
        self.reports: collections.deque = collections.deque(
            maxlen=max(1, self.cfg.max_reports))
        self.runs = 0
        self.skipped = 0          # page-boundary ticks the probe declined
        self._rr = 0              # round-robin cursor over decode slots
        self._shard_seen: dict[int, int] = {}
        self._shard_skips: dict[int, int] = {}

    def due(self, tick: int) -> bool:
        return self.cfg.every_ticks > 0 and tick > 0 \
            and tick % self.cfg.every_ticks == 0

    def pick_slot(self, slots: list[int]) -> Optional[int]:
        """Round-robin over the live decode slots so long-running batches
        get every sequence sampled, not just slot 0."""
        if not slots:
            return None
        slot = sorted(slots)[self._rr % len(slots)]
        self._rr += 1
        return slot

    def fold(self, report: Optional[dict], metrics, *, tick: int,
             rid: Optional[int] = None, recorder=None) -> Optional[dict]:
        """Fold one backend probe result into the registry + report ring.
        ``report`` None means the probe declined (page boundary)."""
        if report is None:
            self.skipped += 1
            metrics.counter(
                "engine_audit_skipped_total",
                "audit probes declined at a page boundary").inc()
            return None
        self.runs += 1
        metrics.counter("engine_audit_runs_total",
                        "exact-attention audit probes run").inc()
        recall = report["recall_per_layer"]
        mean = sum(recall) / max(len(recall), 1)
        worst = min(recall) if recall else 0.0
        g = metrics.gauge(
            "engine_audit_recall",
            "attention-mass recall of the sphere-selected hot set "
            "(last audited sequence)")
        g.set(mean, stat="mean")
        g.set(worst, stat="min")
        h = metrics.histogram(
            "engine_audit_recall_hist",
            "per-layer attention-mass recall across audit samples",
            buckets=RECALL_BUCKETS)
        for r in recall:
            h.observe(r)
        sh = score_histogram(report.get("scores_per_layer"),
                             bins=self.cfg.score_bins)

        per_shard = report.get("per_shard")
        if per_shard:
            rate = metrics.gauge(
                "engine_audit_shard_skip_rate",
                "fraction of audit samples in which a shard's bounded "
                "hot set was empty (its psum contribution skipped)")
            mass = metrics.gauge(
                "engine_audit_shard_mass",
                "attention-mass share resident on each shard "
                "(last audited sequence)")
            for row in per_shard:
                s = row["shard"]
                self._shard_seen[s] = self._shard_seen.get(s, 0) + 1
                self._shard_skips[s] = (self._shard_skips.get(s, 0)
                                        + int(row["skipped"]))
                rate.set(self._shard_skips[s] / self._shard_seen[s],
                         shard=s)
                mass.set(row["mass_share"], shard=s)

        entry = {"tick": tick, "rid": rid, "slot": report["slot"],
                 "length": report["length"],
                 "pages_resident": report["pages_resident"],
                 "pages_hot": report["pages_hot"],
                 "recall_mean": mean, "recall_min": worst,
                 "recall_per_layer": list(recall),
                 "score_hist": sh, "per_shard": per_shard}
        self.reports.append(entry)
        if recorder is not None:
            recorder.record("audit", tick=tick, rid=rid,
                            slot=report["slot"], recall_mean=round(mean, 6),
                            recall_min=round(worst, 6),
                            pages_hot=report["pages_hot"],
                            pages_resident=report["pages_resident"])
        return entry
