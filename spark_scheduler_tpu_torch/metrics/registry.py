"""Tagged metric registry.

The reference leans on palantir/pkg/metrics — a tagged registry of
counters/gauges/histograms flushed every 30s (metrics/metrics.go:79,
SURVEY.md §2c). This is the dependency-free equivalent: thread-safe
counters, gauges, and reservoir histograms keyed by (name, sorted tags),
with a `snapshot()` the reporters/tests consume and `emit()` for JSON-line
output.
"""

from __future__ import annotations

import json
import threading
import time


def _key(name: str, tags: dict[str, str] | None) -> tuple:
    return (name, tuple(sorted((tags or {}).items())))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self.value += delta


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value


class Histogram:
    """Bounded-reservoir histogram with exact small-sample percentiles."""

    __slots__ = ("_values", "_count", "_max", "_min", "_sum", "_lock", "_cap")

    def __init__(self, cap: int = 1024):
        self._values: list[float] = []
        self._count = 0
        # None sentinels: min AND max are exact over ALL samples (a 0.0
        # max initializer would fabricate a never-observed 0.0 for
        # all-negative series).
        self._max: float | None = None
        self._min: float | None = None
        self._sum = 0.0
        self._lock = threading.Lock()
        self._cap = cap

    def update(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._max = value if self._max is None else max(self._max, value)
            self._min = value if self._min is None else min(self._min, value)
            if len(self._values) < self._cap:
                self._values.append(value)
            else:  # reservoir replacement, deterministic stride
                self._values[self._count % self._cap] = value

    def stats(self) -> dict:
        with self._lock:
            vs = sorted(self._values)
            n = len(vs)
            return {
                "count": self._count,
                "max": self._max if self._max is not None else 0.0,
                "min": self._min if self._min is not None else 0.0,
                # Exact running sum — exposition must emit THIS, not
                # mean*count: the reconstruction can shrink by an ulp
                # between scrapes and Prometheus reads any _sum decrease
                # as a counter reset (spurious rate() spikes).
                "sum": self._sum,
                "mean": self._sum / self._count if self._count else 0.0,
                "p50": vs[min(int(0.5 * n), n - 1)] if n else 0.0,
                "p95": vs[min(int(0.95 * n), n - 1)] if n else 0.0,
                "p99": vs[min(int(0.99 * n), n - 1)] if n else 0.0,
            }


class MetricRegistry:
    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, kind, name: str, tags: dict[str, str] | None):
        k = _key(name, tags)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = kind()
                self._metrics[k] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, **tags: str) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags: str) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, **tags: str) -> Histogram:
        return self._get(Histogram, name, tags)

    def unregister(self, name: str, **tags: str) -> None:
        """Drop a metric series (stale-tag cleanup, usage.go:96-113)."""
        with self._lock:
            self._metrics.pop(_key(name, tags), None)

    def snapshot(self) -> dict:
        """{name: [{tags, kind, value|stats}]} — test/reporting view."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, list] = {}
        for (name, tags), m in items:
            if isinstance(m, Counter):
                entry = {"tags": dict(tags), "kind": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                entry = {"tags": dict(tags), "kind": "gauge", "value": m.value}
            else:
                entry = {"tags": dict(tags), "kind": "histogram", **m.stats()}
            out.setdefault(name, []).append(entry)
        return out

    def emit(self, stream, now: float | None = None) -> None:
        """One JSON line per metric series (the 30s metric flush analog).
        Every line of a flush carries the same `time` so readers can group
        lines into ticks and plot the values as a time series."""
        if now is None:
            now = time.time()
        for name, entries in self.snapshot().items():
            for e in entries:
                stream.write(json.dumps({"time": now, "metric": name, **e}) + "\n")
