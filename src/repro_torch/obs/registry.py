"""Metrics registry: counters, gauges, histograms (PyTorch port of
``repro.obs.registry``; DESIGN.md §16).

Pure stdlib: the registry is host-side bookkeeping fed by the Recorder's
piggyback drains. Metric *names* are the single namespace benches and
exporters key on; counter metrics derived from the pool's traffic vector
are keyed by ``state.COUNTER_NAMES`` entries, never by integer position.

Histograms use fixed bucket bounds chosen at creation, so merging two
histograms (multi-run aggregation, per-expander roll-ups) is a plain
bucket-wise add: associative and commutative, with ``sum``/``count``
carried exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# Default bucket upper edges: 1-2-5 decades covering counter deltas
# (accesses per segment) through modeled microseconds. The final +inf
# bucket is implicit (``counts`` has ``len(bounds) + 1`` slots).
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    m * 10 ** e for e in range(0, 7) for m in (1, 2, 5))


class Counter:
    """Monotonically increasing value (events, accesses, bytes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += int(n)

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (freelist headroom, parked lanes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bound histogram. ``bounds`` are inclusive upper edges of the
    first ``len(bounds)`` buckets; one overflow bucket follows. Merging
    requires identical bounds and is a bucket-wise add, so partial
    aggregations (per expander, per run) compose in any order."""

    __slots__ = ("name", "bounds", "counts", "total", "n")

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             f"increasing")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += v
        self.n += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise combine into a NEW histogram (inputs untouched)."""
        if self.bounds != other.bounds:
            raise ValueError(f"histogram merge: bounds differ "
                             f"({self.name} vs {other.name})")
        out = Histogram(self.name, self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.total = self.total + other.total
        out.n = self.n + other.n
        return out

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.total, "count": self.n, "mean": self.mean()}


def merge_histograms(hists: Sequence[Histogram]) -> Optional[Histogram]:
    """Fold ``merge`` over a sequence (order-independent: bucket-wise
    addition is associative and commutative)."""
    out: Optional[Histogram] = None
    for h in hists:
        out = h if out is None else out.merge(h)
    return out


class MetricsRegistry:
    """Get-or-create registry: one flat name -> metric namespace. The
    Recorder is the only writer on the hot path; launchers and exporters
    read ``snapshot()``."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, bounds)
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.snapshot()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.snapshot()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._histograms.items())},
        }
