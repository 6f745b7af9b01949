"""Coordinate-wise robust aggregators over a worker axis (plain PyTorch).

Every aggregator maps ``[m, ...] -> [...]`` over ``axis``. These are the
``backend="torch"`` execution functions of ``core.estimator.Estimator``,
the single dispatch site for robust aggregation; call an Estimator rather
than these. The median of an even worker count averages the two middle
order statistics (``torch.median`` would return the lower one).

The whole-vector (geometric median, Krum) and adaptive estimators of
``repro.core.aggregators`` are not ported yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

import warnings

import torch

__all__ = ["mean", "median", "trimmed_mean", "vrmom"]


def _middle(xs, axis: int):
    m = xs.shape[axis]
    return 0.5 * (xs.select(axis, (m - 1) // 2) + xs.select(axis, m // 2))


def mean(x, axis: int = 0):
    return torch.mean(x, dim=axis)


def median(x, axis: int = 0):
    return _middle(torch.sort(x, dim=axis).values, axis)


def trimmed_mean(x, beta: float = 0.1, axis: int = 0):
    """Coordinate-wise beta-trimmed mean: drop int(beta*m) rows at each
    end. A zero trim is the non-robust mean, so it warns
    (``Estimator.validate`` makes it an error)."""
    m = x.shape[axis]
    k = int(beta * m)
    if k == 0:
        warnings.warn(
            f"trimmed_mean: beta={beta} trims int({beta}*{m}) = 0 rows per "
            f"end — degenerating to the NON-robust mean. Raise beta to at "
            f"least {1.0 / m:.4g}.", RuntimeWarning, stacklevel=2)
    hi = m - k if m - k > k else k + 1
    xs = torch.sort(x, dim=axis).values
    return torch.mean(xs.narrow(axis, k, hi - k), dim=axis)


def vrmom(x, K: int = 10, axis: int = 0, eps: float = 1e-12):
    """VRMOM, eq. (7), with the MAD scale: f32 math, x's dtype out."""
    from . import vrmom as _V  # which imports this module

    return _V.vrmom(x, K=K, axis=axis, scale="mad", eps=eps)
