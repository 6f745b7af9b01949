"""Metrics sinks: JSONL records and Prometheus text exposition.

Stdlib-only (``repro.obs.sinks``'s port, the same wire format, so either
package reads the other's files). One JSONL artifact carries a run's
telemetry: records of ``kind: "metrics"`` (a registry snapshot plus
meta); :func:`merge_records` folds a file back into one summary and
:func:`prometheus_text` renders it as Prometheus text.

Wire format (one JSON object per line):

    {"kind": "metrics", "counters": {...}, "gauges": {...},
     "histograms": {name: {edges, counts, sum, count, min, max}},
     "meta": {...}}
"""
from __future__ import annotations

import json
from typing import IO, Iterable, List, Optional

from .metrics import Histogram, MetricsRegistry

__all__ = [
    "JsonlSink",
    "read_jsonl",
    "merge_records",
    "prometheus_text",
]


class JsonlSink:
    """Append-mode JSONL writer (context manager)."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        self._f: Optional[IO[str]] = open(path, "a" if append else "w")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def write_registry(self, reg: MetricsRegistry, **meta) -> None:
        rec = {"kind": "metrics", **reg.snapshot()}
        if meta:
            rec["meta"] = meta
        self.write(rec)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge_records(records: Iterable[dict]) -> dict:
    """Fold JSONL records into one summary: counters sum, gauges take
    the last value, histograms merge (matching edges required)."""
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for rec in records:
        for k, v in rec.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)
        for k, v in rec.get("gauges", {}).items():
            gauges[k] = float(v)
        for k, snap in rec.get("histograms", {}).items():
            h = Histogram.from_snapshot(snap)
            if k in hists:
                hists[k].merge(h)
            else:
                hists[k] = h
    return {"counters": counters, "gauges": gauges,
            "histograms": {k: h.snapshot() for k, h in hists.items()}}


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(summary: dict) -> str:
    """Prometheus text exposition of a merged summary (or a single
    registry snapshot — same schema)."""
    lines: List[str] = []
    for name in sorted(summary.get("counters", {})):
        pn = _prom_name(name)
        # classic text format: the TYPE line must name the sample family
        # (_total included), or strict parsers treat it as untyped
        lines.append(f"# TYPE {pn}_total counter")
        lines.append(f"{pn}_total {_fmt(summary['counters'][name])}")
    for name in sorted(summary.get("gauges", {})):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(summary['gauges'][name])}")
    for name in sorted(summary.get("histograms", {})):
        snap = summary["histograms"][name]
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        edges, counts = snap["edges"], snap["counts"]
        for e, c in zip(edges, counts[:-1]):
            cum += int(c)
            lines.append(f'{pn}_bucket{{le="{_fmt(e)}"}} {cum}')
        cum += int(counts[-1])
        lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pn}_sum {_fmt(snap['sum'])}")
        lines.append(f"{pn}_count {int(snap['count'])}")
    return "\n".join(lines) + "\n"
