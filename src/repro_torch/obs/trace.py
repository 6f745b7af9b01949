"""Profiler spans: name the subsystems in ``torch.profiler`` traces
(``repro.obs.trace``'s port).

Both helpers open a ``torch.profiler.record_function`` range, a host-side
span that a trace shows with the device work launched inside it:

* ``trace_span(name)`` — wraps dispatch and blocking work, so the
  timeline attributes host time per subsystem (``serve.admit``,
  ``serve.decode_pool``).
* ``named_span(name)`` — names a stretch of device work
  (``serve.decode_scan``, the replays of ``generate``). ``repro`` names
  its staged ops at trace time; a range in the profiler is the PyTorch
  counterpart. Neither is ever opened inside a captured step.

With no profiler running, a span costs one host call on entry and exit.
"""
from __future__ import annotations

import torch

__all__ = ["trace_span", "named_span"]


def trace_span(name: str):
    """A profiler span (a context manager)."""
    return torch.profiler.record_function(name)


# ``repro``'s second name, kept so that call sites read alike in both
# packages: in PyTorch both kinds of span are the same range
named_span = trace_span
