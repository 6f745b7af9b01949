"""Device-side diagnostics of aggregation (``repro.obs.diag``'s port).

Training (the stacked gradient against its aggregate):

* ``AggDiagnostics`` — per worker, the L2 deviation of its row from the
  robust aggregate summed over every leaf (``scores``), a robust z-score
  outlier mask over them (``suspected``: MAD-scaled, with a 5 % relative
  floor so an all-honest stack flags no one), the fraction suspected
  (``alpha_hat``), the per-worker gradient norms and the aggregate's.
* ``finalize_diag``, ``diagnose`` (one stacked tensor) and
  ``tree_diagnose`` (a stacked tree, second moments added leaf by leaf
  and, within a leaf, over column blocks, so no f32 copy of a whole
  stack exists).

Serving:

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
the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from ..core.vrmom import mad_scale, mom
from ..tree import leaves as _leaves

__all__ = ["AggDiagnostics", "finalize_diag", "diagnose", "tree_diagnose",
           "replica_disagreement", "histogram_counts", "ServeDiag",
           "serve_diag"]

# Suspicion threshold on the robust z-score (``repro``'s): a worker is
# flagged when its score exceeds the median score by > 4 MAD-sigmas AND by
# > 20 % of the median (the 5 % floor in the denominator).
_Z_THRESH = 4.0
_REL_FLOOR = 0.05
# columns of a stack made f32 at a time in the second moments
_COLUMN_BLOCK = 1 << 25


class AggDiagnostics(NamedTuple):
    """Per-step aggregation diagnostics (W = worker count), on the
    device."""

    scores: torch.Tensor     # [W] f32 — L2 deviation from the aggregate
    suspected: torch.Tensor  # [W] bool — robust-outlier mask
    alpha_hat: torch.Tensor  # []  f32 — fraction suspected
    pre_norms: torch.Tensor  # [W] f32 — per-worker gradient L2 norms
    post_norm: torch.Tensor  # []  f32 — aggregate gradient L2 norm


def finalize_diag(dev_sq, pre_sq, post_sq) -> AggDiagnostics:
    """Deviation/norm second moments -> AggDiagnostics (all f32)."""
    dev = torch.sqrt(dev_sq.float())
    center = mom(dev, axis=0)
    scale = mad_scale(dev, axis=0, center=center)
    z = (dev - center) / (scale + _REL_FLOOR * center + 1e-12)
    suspected = z > _Z_THRESH
    return AggDiagnostics(
        scores=dev,
        suspected=suspected,
        alpha_hat=torch.mean(suspected.float()),
        pre_norms=torch.sqrt(pre_sq.float()),
        post_norm=torch.sqrt(post_sq.float()),
    )


def _add_moments(acc, x, agg):
    """Add one stacked leaf's (x [W, ...], agg [...]) second moments into
    ``acc`` = [dev_sq [W], pre_sq [W], post_sq []], in f32, a block of
    columns at a time."""
    w = x.shape[0]
    xf, af = x.reshape(w, -1), agg.reshape(-1)
    for c0 in range(0, af.numel(), _COLUMN_BLOCK):
        xs = xf[:, c0:c0 + _COLUMN_BLOCK].float()
        a = af[c0:c0 + _COLUMN_BLOCK].float()
        acc[0] += torch.sum(torch.square(xs - a[None]), dim=1)
        acc[1] += torch.sum(torch.square(xs), dim=1)
        acc[2] += torch.sum(torch.square(a))


def _zeros(w: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return [torch.zeros((w,), **f32), torch.zeros((w,), **f32),
            torch.zeros((), **f32)]


def diagnose(x, agg, axis: int = 0) -> AggDiagnostics:
    """Diagnostics of one stacked tensor ``x`` (workers on ``axis``)
    against its aggregate ``agg`` (x without the worker dim)."""
    x = torch.movedim(x, axis, 0)
    acc = _zeros(x.shape[0], x.device)
    _add_moments(acc, x, agg)
    return finalize_diag(*acc)


def tree_diagnose(stacked, agg) -> AggDiagnostics:
    """Diagnostics of a stacked-gradient tree (dict, leaves ``[W, ...]``)
    against the aggregated tree, the second moments added leaf by leaf."""
    sl, al = list(_leaves(stacked)), list(_leaves(agg))
    acc = _zeros(sl[0].shape[0], sl[0].device)
    for s, a in zip(sl, al):
        _add_moments(acc, s, a)
    return finalize_diag(*acc)


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
