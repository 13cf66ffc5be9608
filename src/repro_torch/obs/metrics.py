"""Gauges and log-spaced histograms behind one registry (stdlib only).

The part of the JAX package's metrics registry that the session uses:
``Registry.observe`` into a :class:`Histogram` and ``Registry.set`` of a
:class:`Gauge`, with the same binning and the same snapshot keys.  Names are
slash-namespaced (``session/query_s``).  A record is a few dict updates
under one lock, cheap enough for every query batch.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

__all__ = ["Gauge", "Histogram", "Registry"]


class Histogram:
    """Log-spaced histogram with quantile estimation (seconds by default).

    Bins span ``lo``..``hi`` with ``bins_per_decade`` log10-spaced buckets
    (default: 1us..1000s, 10 buckets/decade => 91 bins).  ``percentile``
    returns the upper edge of the bucket holding the requested rank, clamped
    to the exact observed max.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 bins_per_decade: int = 10):
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        n = int(round(math.log10(hi / lo) * bins_per_decade))
        self._edges = [lo * 10.0 ** (i / bins_per_decade)
                       for i in range(1, n + 1)]
        self._counts = [0] * (n + 1)        # +1: overflow bucket above hi
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self._counts[bisect_left(self._edges, s)] += 1
        self.count += 1
        self.sum += s
        self.max = max(self.max, s)

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> seconds (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank and c:
                edge = self._edges[i] if i < len(self._edges) else self.max
                return min(edge, self.max)
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.sum / self.count if self.count else 0.0,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
            "max_s": self.max,
        }


class Gauge:
    """A point-in-time value with a declared fleet merge mode
    (``'sum'``, ``'max'`` or ``'last'``)."""

    __slots__ = ("value", "merge")

    def __init__(self, merge: str = "last"):
        if merge not in ("sum", "max", "last"):
            raise ValueError(f"unknown gauge merge mode: {merge!r}")
        self.value = 0.0
        self.merge = merge

    def set(self, v: float) -> None:
        self.value = float(v)


class Registry:
    """Named gauges and histograms with a JSON snapshot.

    ``reg.observe("session/query_s", 0.012)`` records into a histogram,
    ``reg.set("compiled_buckets", 3, merge="max")`` sets a gauge; both
    create the metric on first use.  Thread-safe.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def gauge(self, name: str, merge: str = "last") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(merge)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def set(self, name: str, v: float, merge: str = "last") -> None:
        self.gauge(name, merge).set(v)

    def observe(self, name: str, seconds: float) -> None:
        h = self.histogram(name)
        with self._lock:
            h.record(seconds)

    def snapshot(self) -> dict:
        """Gauge values and histogram quantiles."""
        with self._lock:
            return {
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }
