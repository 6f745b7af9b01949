"""Host-side metrics: fixed-edge histograms, counters, gauges, clocks.

Stdlib-only by design (``repro.obs.metrics``'s port). Device code never
calls into this module: the device half of the telemetry layer lives in
:mod:`repro_torch.obs.diag` (fixed-shape counts tensors accumulated on the
card) and is *drained* into a :class:`MetricsRegistry` on the host, after
the decode dispatch returns.

This module is also the port's single wall-clock site: no other module of
``src/repro_torch/`` reads ``time.time``/``perf_counter``, so every
duration the port reports flows through one clock (``now()``) and one
recording vocabulary (the catalog names).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence

from . import catalog as CAT

__all__ = ["now", "Histogram", "MetricsRegistry"]


def now() -> float:
    """Monotonic wall-clock read — the obs layer's only timer source."""
    return time.perf_counter()


class Histogram:
    """Fixed-edge histogram: counts per bucket + sum/count/min/max.

    Bucket ``i`` covers ``(edges[i-1], edges[i]]`` (bucket 0 is the
    underflow ``(-inf, edges[0]]``, the last bucket the overflow
    ``(edges[-1], inf)``) — the same convention as
    ``obs.diag.histogram_counts``, so device-computed counts vectors merge
    losslessly via :meth:`merge_counts`.
    """

    __slots__ = ("edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- recording ----------------------------------------------------------

    def record(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def record_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    def merge_counts(self, counts: Sequence[int], total: float,
                     n: int) -> None:
        """Drain a device-computed counts vector (``diag.histogram_counts``
        convention: ``len(edges) + 1`` buckets) plus its sum and count.
        Min/max are only known to bucket resolution, so the extreme
        nonempty buckets' bounds stand in for them."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"counts length {len(counts)} does not match "
                f"{len(self.counts)} buckets of edges {len(self.edges)}")
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.sum += float(total)
        self.count += int(n)
        nz = [i for i, c in enumerate(counts) if c]
        if nz:
            lo = self.edges[nz[0] - 1] if nz[0] > 0 else self.edges[0]
            hi = (self.edges[nz[-1]] if nz[-1] < len(self.edges)
                  else self.edges[-1])
            self.min = lo if self.min is None else min(self.min, lo)
            self.max = hi if self.max is None else max(self.max, hi)

    # -- queries ------------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Linear interpolation within the bucket holding rank q/100,
        with the extreme buckets clamped to the observed min/max."""
        if not self.count:
            return float("nan")
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else self.min
                hi = (self.edges[i] if i < len(self.edges) else self.max)
                if self.min is not None:
                    lo = min(max(lo, self.min), self.max)
                    hi = max(min(hi, self.max), self.min)
                frac = max(target - cum, 0.0) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(snap["edges"])
        h.counts = [int(c) for c in snap["counts"]]
        h.sum = float(snap["sum"])
        h.count = int(snap["count"])
        h.min = snap.get("min")
        h.max = snap.get("max")
        return h

    def merge(self, other: "Histogram") -> None:
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        for attr, pick in (("min", min), ("max", max)):
            theirs = getattr(other, attr)
            if theirs is not None:
                mine = getattr(self, attr)
                setattr(self, attr,
                        theirs if mine is None else pick(mine, theirs))


class MetricsRegistry:
    """Counters, gauges and histograms keyed by catalog names.

    The host-side accumulation point of the telemetry layer: device code
    accumulates fixed-shape counts, host code drains them here; sinks
    (:mod:`repro_torch.obs.sinks`) serialize :meth:`snapshot` to JSONL /
    Prometheus text. Unknown names are accepted (the catalog documents);
    histogram edges default to the catalog entry for the name.
    """

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- recording ----------------------------------------------------------

    def counter(self, name: str, n: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(n)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                edges if edges is not None else CAT.default_edges(name))
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    @contextlib.contextmanager
    def timer(self, name: str, kind: str = "histogram"):
        """Time a block into ``name`` (histogram sample or gauge set)."""
        t0 = now()
        try:
            yield
        finally:
            dt = now() - t0
            if kind == "gauge":
                self.gauge(name, dt)
            else:
                self.observe(name, dt)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }
