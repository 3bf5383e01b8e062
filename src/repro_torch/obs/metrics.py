"""Serving metrics: counters / gauges / histograms with label sets.

A ``MetricsRegistry`` owns named metrics; each metric holds one series
per label-set (``tuple(sorted(labels.items()))`` key), so per-SLA and
per-shard breakdowns are just labels on the same counter. Everything is
plain host-side Python — incrementing a counter is a dict lookup and an
add — and the registry renders a Prometheus-style text exposition for
``launch/serve.py --metrics``.
"""

from __future__ import annotations

from typing import Optional


def _key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f'{k}="{v}"' for k, v in key)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.series: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        return self.series.get(_key(labels), 0.0)

    def snapshot(self):
        """Scalar for a single unlabeled series, else {label_str: value}."""
        if len(self.series) == 1 and () in self.series:
            return self.series[()]
        return {_label_str(k) or "": v for k, v in sorted(self.series.items())}

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, val in sorted(self.series.items()):
            label = "{" + _label_str(key) + "}" if key else ""
            lines.append(f"{self.name}{label} {val:g}")
        return lines


class Counter(_Metric):
    """Monotonically non-decreasing; ``inc`` with a negative amount raises."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _key(labels)
        self.series[key] = self.series.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[_key(labels)] = float(value)


# seconds-scale buckets: 1ms .. 10s covers tick phases through requests
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(buckets)
        # per label-set: {"counts": [..per bucket.. , +Inf], "sum", "count"}
        self.series: dict[tuple, dict] = {}

    def observe(self, value: float, **labels) -> None:
        key = _key(labels)
        s = self.series.get(key)
        if s is None:
            s = {"counts": [0] * (len(self.buckets) + 1),
                 "sum": 0.0, "count": 0}
            self.series[key] = s
        for i, b in enumerate(self.buckets):
            if value <= b:
                s["counts"][i] += 1
                break
        else:
            s["counts"][-1] += 1
        s["sum"] += value
        s["count"] += 1

    def value(self, **labels):
        s = self.series.get(_key(labels))
        return None if s is None else dict(s)

    def snapshot(self):
        out = {}
        for key, s in sorted(self.series.items()):
            out[_label_str(key) or ""] = {
                "count": s["count"],
                "sum": round(s["sum"], 6),
                "mean": round(s["sum"] / s["count"], 6) if s["count"] else 0.0,
            }
        if len(out) == 1 and "" in out:
            return out[""]
        return out

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        for key, s in sorted(self.series.items()):
            base = _label_str(key)
            cum = 0
            for b, c in zip(self.buckets, s["counts"]):
                cum += c
                le = f'le="{b:g}"'
                label = "{" + (base + "," if base else "") + le + "}"
                lines.append(f"{self.name}_bucket{label} {cum}")
            cum += s["counts"][-1]
            label = "{" + (base + "," if base else "") + 'le="+Inf"' + "}"
            lines.append(f"{self.name}_bucket{label} {cum}")
            suffix = "{" + base + "}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {s['sum']:g}")
            lines.append(f"{self.name}_count{suffix} {s['count']}")
        return lines


class MetricsRegistry:
    """Get-or-create registry; re-registering a name with a different
    metric type is an error (a silent type change would corrupt series)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def render_prometheus(self) -> str:
        lines = []
        for _, m in sorted(self._metrics.items()):
            lines.extend(m.render())
        return "\n".join(lines) + "\n" if lines else ""
