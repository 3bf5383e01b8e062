"""Per-phase time table from an exported trace of the PyTorch port.

The twin of ``tools/trace_summary.py``, over ``repro_torch.obs``.

Run:  python tools/torch_trace_summary.py TRACE.jsonl [...]
      python tools/torch_trace_summary.py --accounting BUNDLE_DIR
      python tools/torch_trace_summary.py --accounting metrics.json

Accepts either export format (``Tracer.export_jsonl`` / ``export_chrome``)
and prints where tick time went: total and per-tick milliseconds in the
admit / prefill / decode phases, swap activity (preempt + swap-in +
shed, nested inside the phases), the host-side remainder, and how much
was first-call compile time.

``--accounting`` instead renders the KV accounting table from a metrics
registry snapshot (a ``metrics.json``, or an ``LLM.debug_bundle()``
directory containing one): pages by state, pool tier occupancy, bytes
saved by hot-width skipping and the int8 tier, swap traffic, watchdog
and audit status (see docs/observability.md).
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.obs import (format_table, load_trace,  # noqa: E402
                             phase_summary)


def _labels(label_str: str) -> dict:
    """'dir="out",kind="shed"' -> {"dir": "out", "kind": "shed"}."""
    return dict(re.findall(r'(\w+)="([^"]*)"', label_str))


def _series(snapshot: dict, name: str) -> list[tuple[dict, float]]:
    """A metric's (labels, value) rows; scalars get empty labels."""
    v = snapshot.get(name)
    if v is None:
        return []
    if isinstance(v, dict) and any(
            isinstance(x, (int, float)) for x in v.values()):
        return [(_labels(k), x) for k, x in v.items()
                if isinstance(x, (int, float))]
    if isinstance(v, (int, float)):
        return [({}, v)]
    return []


def _pick(rows, **want) -> float:
    for labels, v in rows:
        if all(labels.get(k) == val for k, val in want.items()):
            return v
    return 0.0


def _mb(n: float) -> str:
    return f"{n / 1e6:.2f}MB"


def accounting_table(snapshot: dict, title: str = "accounting") -> str:
    """Render the KV accounting table from a metrics snapshot dict
    (``MetricsRegistry.snapshot()`` / a bundle's metrics.json)."""
    lines = [f"== {title} =="]
    pages = _series(snapshot, "engine_kv_pages")
    if pages:
        lines.append("pages by state   : " + "  ".join(
            f"{labels.get('state', '?')}={int(v)}"
            for labels, v in sorted(pages,
                                    key=lambda r: r[0].get("state", ""))))
    pool = _series(snapshot, "engine_kv_pool_pages")
    unsharded = [(l, v) for l, v in pool if "shard" not in l]
    if unsharded:
        lines.append("pool occupancy   : " + "  ".join(
            f"{l.get('tier') or l.get('kind')}={int(v)}"
            for l, v in unsharded))
    for l, v in sorted(((l, v) for l, v in pool if "shard" in l),
                       key=lambda r: (r[0]["shard"], r[0].get("tier", ""))):
        lines.append(f"  shard {l['shard']} tier {l.get('tier')}: {int(v)}")
    frag = _pick(_series(snapshot, "engine_kv_fragmentation_frac"))
    lines.append(f"fragmentation    : {100 * frag:.1f}%")
    cons = _pick(_series(snapshot, "engine_kv_conservation_error"))
    lines.append(f"conservation err : {int(cons)}")

    considered = _pick(_series(
        snapshot, "engine_decode_pages_considered_total"))
    skipped = _pick(_series(snapshot, "engine_decode_pages_skipped_total"))
    saved = _pick(_series(snapshot, "engine_decode_bytes_skipped_total"))
    frac = skipped / considered if considered else 0.0
    lines.append(f"decode gather    : considered={int(considered)}  "
                 f"skipped={int(skipped)} ({100 * frac:.1f}%)  "
                 f"bytes saved={_mb(saved)}")

    qp = _pick(_series(snapshot, "engine_pages_quantized_total"))
    qb = _pick(_series(snapshot, "engine_quantize_bytes_total"))
    lines.append(f"quantize traffic : pages={int(qp)}  bytes={_mb(qb)}")

    swp = _series(snapshot, "engine_pages_swapped_total")
    swb = _series(snapshot, "engine_swap_bytes_total")
    if swp:
        parts = []
        for labels, v in sorted(swp, key=lambda r: (r[0].get("dir", ""),
                                                    r[0].get("kind", ""))):
            b = _pick(swb, **labels)
            parts.append(f"{labels.get('dir')}:{labels.get('kind')}"
                         f"={int(v)}p/{_mb(b)}")
        lines.append("swap traffic     : " + "  ".join(parts))
    else:
        lines.append("swap traffic     : none")

    wd = _pick(_series(snapshot, "engine_watchdog_violations_total"))
    lines.append(f"watchdog         : {int(wd)} violations")
    runs = _pick(_series(snapshot, "engine_audit_runs_total"))
    if runs:
        rec = _series(snapshot, "engine_audit_recall")
        lines.append(f"audit            : runs={int(runs)}  "
                     f"recall mean={_pick(rec, stat='mean'):.4f}  "
                     f"min={_pick(rec, stat='min'):.4f}")
    return "\n".join(lines)


def _accounting_main(paths: list[str]) -> int:
    if not paths:
        print("usage: torch_trace_summary.py --accounting "
              "BUNDLE_DIR_OR_METRICS_JSON [...]")
        return 2
    for raw in paths:
        p = pathlib.Path(raw)
        src = p / "metrics.json" if p.is_dir() else p
        with open(src) as f:
            snapshot = json.load(f)
        print(accounting_table(snapshot, title=str(src)))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--accounting":
        return _accounting_main(argv[1:])
    if not argv:
        print(__doc__.strip().splitlines()[0])
        print("usage: torch_trace_summary.py [--accounting] "
              "TRACE.jsonl [TRACE2.json ...]")
        return 2
    for path in argv:
        events = load_trace(path)
        print(format_table(phase_summary(events),
                           title=pathlib.Path(path).stem))
    return 0


if __name__ == "__main__":
    sys.exit(main())
