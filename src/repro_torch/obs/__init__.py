"""``repro_torch.obs``: telemetry for serving and training (``repro.obs``'s
port).

* :mod:`~repro_torch.obs.catalog` — canonical metric names, kinds and
  bucket edges (stdlib-only).
* :mod:`~repro_torch.obs.metrics` — host-side ``MetricsRegistry``,
  fixed-edge ``Histogram`` (with percentiles), and ``now()``, the port's
  single wall-clock site.
* :mod:`~repro_torch.obs.sinks`   — JSONL writer + Prometheus text
  exposition.
* :mod:`~repro_torch.obs.diag`    — device-side diagnostics: the train
  step's per-worker suspicion scores (``AggDiagnostics``) and the serve
  path's replica disagreement and histogram counts, as fixed-shape
  tensors a captured decode step can accumulate. Imports torch.
* :mod:`~repro_torch.obs.trace`   — profiler spans
  (``torch.profiler.record_function``). Imports torch.

The stdlib-only half (catalog, metrics, sinks) is imported eagerly, so
``repro_torch.obs`` works where torch is not installed; the torch half
loads lazily on attribute access.
"""
from __future__ import annotations

from . import catalog, metrics, sinks
from .metrics import Histogram, MetricsRegistry, now
from .sinks import JsonlSink, merge_records, prometheus_text, read_jsonl

__all__ = [
    "catalog",
    "metrics",
    "sinks",
    "diag",
    "trace",
    "Histogram",
    "MetricsRegistry",
    "now",
    "JsonlSink",
    "read_jsonl",
    "merge_records",
    "prometheus_text",
    "trace_span",
    "named_span",
]

_LAZY = {
    "diag": (".diag", None),
    "trace": (".trace", None),
    "trace_span": (".trace", "trace_span"),
    "named_span": (".trace", "named_span"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(entry[0], __name__)
    obj = mod if entry[1] is None else getattr(mod, entry[1])
    globals()[name] = obj
    return obj
