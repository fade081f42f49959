"""Counters, gauges, and log-bucketed histograms (DESIGN.md §14.2).

Pure-python instruments with fixed memory per sample class:

* :class:`Counter` — a monotonically increasing number;
* :class:`Gauge`   — a timestamped series of set values (queue depth,
  batch occupancy, per-superstep residual — the "series" artifacts);
* :class:`Histogram` — fixed log-spaced buckets (five per decade over
  ``[1 µs, 100 s]`` by default) so latency distributions accumulate in
  O(1) per observation and merge across runs bucket-by-bucket.

A registry is type-strict: asking for ``counter("x")`` after ``gauge("x")``
is a bug, not a silent re-type.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: log-spaced bucket upper edges: 5 per decade, 1e-6 .. 1e2 seconds.
#: values land in the first bucket whose (inclusive) upper edge reaches
#: them; anything beyond the last edge goes to one overflow bucket.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (k / 5.0) for k in range(-30, 11)
)


def bucket_index(value: float, edges: Tuple[float, ...] = DEFAULT_BUCKETS) -> int:
    """Index of the bucket ``value`` falls in (``len(edges)`` = overflow)."""
    return bisect.bisect_left(edges, value)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_line(self) -> Dict[str, Any]:
        return {
            "kind": "metric",
            "type": "counter",
            "name": self.name,
            "value": self.value,
        }


class Gauge:
    __slots__ = ("name", "_clock", "series")

    def __init__(self, name: str, clock):
        self.name = name
        self._clock = clock
        self.series: List[Tuple[float, float]] = []

    def set(self, value: float) -> None:
        self.series.append((self._clock(), float(value)))

    @property
    def value(self) -> Optional[float]:
        return self.series[-1][1] if self.series else None

    def to_line(self) -> Dict[str, Any]:
        return {
            "kind": "metric",
            "type": "gauge",
            "name": self.name,
            "last": self.value,
            "series": [[t, v] for t, v in self.series],
        }


class Histogram:
    __slots__ = ("name", "edges", "counts", "count", "total", "min", "max")

    def __init__(self, name: str, edges: Tuple[float, ...] = DEFAULT_BUCKETS):
        if not edges or list(edges) != sorted(edges):
            raise ValueError("histogram edges must be a sorted non-empty tuple")
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bucket_index(value, self.edges)] += 1
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def percentile(self, q: float) -> Optional[float]:
        """Upper bucket edge covering quantile ``q`` (conservative bound),
        clamped into the observed [min, max] envelope."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                edge = self.edges[i] if i < len(self.edges) else self.max
                return float(min(max(edge, self.min), self.max))
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram bucket-by-bucket (in place).

        The mergeability contract the segment-rotation sink and the SLO
        window arithmetic rely on: two histograms over the same edges
        combine exactly (counts add, the [min, max] envelope widens).
        """
        if self.edges != other.edges:
            raise ValueError(
                f"cannot merge histograms with different edges "
                f"({len(self.edges)} vs {len(other.edges)})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    @classmethod
    def from_line(cls, line: Dict[str, Any]) -> "Histogram":
        """Rebuild a histogram from its :meth:`to_line` record."""
        h = cls(line["name"], tuple(line["edges"]))
        counts = list(line["counts"])
        if len(counts) != len(h.counts):
            raise ValueError(
                f"histogram line carries {len(counts)} counts for "
                f"{len(h.edges)} edges"
            )
        h.counts = counts
        h.count = int(line["count"])
        h.total = float(line["sum"])
        h.min = None if line.get("min") is None else float(line["min"])
        h.max = None if line.get("max") is None else float(line["max"])
        return h

    def to_line(self) -> Dict[str, Any]:
        return {
            "kind": "metric",
            "type": "histogram",
            "name": self.name,
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "edges": list(self.edges),
            "counts": list(self.counts),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Name-keyed, type-strict instrument store."""

    def __init__(self, clock=None):
        self._clock = time.monotonic if clock is None else clock
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls, factory):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, factory())
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"not a {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, self._clock))

    def histogram(
        self, name: str, edges: Tuple[float, ...] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, edges))

    def peek(self, name: str) -> Optional[Any]:
        """The instrument registered under ``name``, or None — never
        creates one (the SLO watchdog reads without perturbing)."""
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def to_lines(self) -> List[Dict[str, Any]]:
        """One JSONL-able record per instrument, name-sorted."""
        return [self._instruments[n].to_line() for n in self.names()]
