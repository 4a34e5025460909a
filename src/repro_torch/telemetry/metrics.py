"""Named counters / gauges / histograms with a registry (port of
`repro.telemetry.metrics`, unchanged: it imports nothing of JAX; DESIGN.md
§7).

Replaces the ad-hoc stat dicts scattered through the pipeline (PlanCache's
private hit/miss ints, SurveyEngine's hand-rolled stats) with one shared
vocabulary:

    from repro_torch.telemetry import metrics
    metrics.registry().counter("plan_cache.hits").inc()
    metrics.registry().histogram("survey.batch_s").observe(dt)
    snap = metrics.registry().snapshot()   # plain JSON-able dict

Everything is thread-safe and always-on (a counter bump is one lock +
one add — unlike spans there is no measurable cost to leaving these
live), so subsystems keep exact counts whether or not `--telemetry`
asked for an export.  `snapshot()` is the serialization boundary;
`merge_snapshots` folds snapshots from multiple runs/processes
(counters sum, gauges last-wins, histograms merge moments).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-written value (e.g. current bucket_cap, resident plan count)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Streaming moments of an observed value (count/total/min/max/mean).

    Deliberately bucket-free: the spans layer already keeps every raw
    interval, so the histogram's job is cheap aggregate stats for the
    run report, not distribution plots.
    """

    __slots__ = ("name", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        if not self.count:
            return {"count": 0, "total": 0.0, "min": None, "max": None,
                    "mean": None}
        return {"count": self.count, "total": self.total, "min": self.min,
                "max": self.max, "mean": self.mean}


class MetricsRegistry:
    """Get-or-create store of named metrics.

    A name is one kind only — asking for `counter("x")` after
    `gauge("x")` is a bug and raises."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """JSON-able `{"counters": {...}, "gauges": {...},
        "histograms": {...}}` — the serialization boundary every report
        and export goes through."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def clear(self):
        with self._lock:
            self._metrics.clear()


def merge_snapshots(a: dict, b: dict) -> dict:
    """Fold two `snapshot()` dicts: counters SUM, gauges LAST-WINS (b over
    a), histograms merge count/total/min/max exactly (mean recomputed)."""
    out = {"counters": dict(a.get("counters", {})),
           "gauges": dict(a.get("gauges", {})),
           "histograms": {k: dict(v)
                          for k, v in a.get("histograms", {}).items()}}
    for name, v in b.get("counters", {}).items():
        out["counters"][name] = out["counters"].get(name, 0) + v
    out["gauges"].update(b.get("gauges", {}))
    for name, h in b.get("histograms", {}).items():
        cur = out["histograms"].get(name)
        if cur is None or not cur["count"]:
            out["histograms"][name] = dict(h)
            continue
        if not h["count"]:
            continue
        merged = {
            "count": cur["count"] + h["count"],
            "total": cur["total"] + h["total"],
            "min": min(cur["min"], h["min"]),
            "max": max(cur["max"], h["max"]),
        }
        merged["mean"] = merged["total"] / merged["count"]
        out["histograms"][name] = merged
    return out


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "merge_snapshots", "registry"]
