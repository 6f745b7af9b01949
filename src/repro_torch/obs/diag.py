"""Device-side diagnostics of the serve path (``repro.obs.diag``'s serve
half).

* ``replica_disagreement`` — per token, the fraction of decode replicas
  whose argmax differs from the served (aggregated) token: the live
  Byzantine signal, 0 for an all-honest replica set.
* ``histogram_counts`` — the device half of the fixed-edge histogram
  convention (bucket ``i`` = ``(edges[i-1], edges[i]]``): a
  ``[len(edges)+1]`` int32 counts tensor that
  ``obs.metrics.Histogram.merge_counts`` drains on the host.
* ``ServeDiag`` / ``serve_diag`` — the counts plus the sum of the rates.

Every shape is fixed and nothing reads a device value on the host, so a
captured decode step accumulates them: ``torch.searchsorted`` and
``index_add_`` in place of ``torch.bincount``, which reads its maximum on
the host. The train half (``diagnose``, ``tree_diagnose``,
``AggDiagnostics``) comes with the training slice (ROADMAP.md, queue A4).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

__all__ = ["replica_disagreement", "histogram_counts", "ServeDiag",
           "serve_diag"]


def replica_disagreement(logits_r, agg) -> torch.Tensor:
    """[m, B, V] replica logits + [B, V] aggregate -> [B] f32 fraction of
    replicas whose argmax differs from the aggregated token."""
    rep_tok = torch.argmax(logits_r, dim=-1)          # [m, B]
    agg_tok = torch.argmax(agg, dim=-1)               # [B]
    return (rep_tok != agg_tok[None]).float().mean(dim=0)


def _edges(edges, device) -> torch.Tensor:
    if torch.is_tensor(edges):
        return edges
    return torch.tensor(tuple(edges), dtype=torch.float32, device=device)


def histogram_counts(x, edges: Union[Sequence[float], torch.Tensor],
                     mask=None) -> torch.Tensor:
    """Fixed-edge histogram counts of ``x`` (any shape, raveled) as a
    ``[len(edges)+1]`` int32 tensor on ``x``'s device. Bucket ``i`` covers
    ``(edges[i-1], edges[i]]``, as ``obs.metrics.Histogram`` buckets, so
    the counts drain through ``Histogram.merge_counts`` with no rebinning.
    ``edges``: a sequence, or an f32 tensor of them already on the device
    (a captured step takes that: a sequence is copied from the host).
    ``mask`` (bool, broadcastable to ``x``) excludes entries without
    changing the shape: a masked-out value adds 0 to its bucket."""
    e = _edges(edges, x.device)
    idx = torch.searchsorted(e, x.float().reshape(-1), right=False)
    if mask is None:
        w = torch.ones(idx.shape, dtype=torch.int32, device=x.device)
    else:
        w = torch.broadcast_to(mask, x.shape).reshape(-1).to(torch.int32)
    counts = torch.zeros((e.shape[0] + 1,), dtype=torch.int32,
                         device=x.device)
    return counts.index_add_(0, idx, w)


class ServeDiag(NamedTuple):
    """Serve-loop diagnostics: fixed-edge counts of the per-token
    replica-disagreement rates plus their sum (their number is the sum of
    the counts)."""

    counts: torch.Tensor  # [len(FRACTION_EDGES)+1] int32
    total: torch.Tensor   # [] f32 — sum of the rates


def serve_diag(rates, edges, mask=None) -> ServeDiag:
    """``mask`` (bool, broadcastable to ``rates``) restricts the histogram
    and the sum to live entries: the pool passes its active-slot mask, so
    free slots decoding stale caches do not dilute the Byzantine signal."""
    r = rates.float()
    if mask is not None:
        r = r * torch.broadcast_to(mask, r.shape).float()
    return ServeDiag(counts=histogram_counts(rates, edges, mask=mask),
                     total=torch.sum(r))
