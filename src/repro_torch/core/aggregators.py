"""Robust aggregators over a worker axis (plain PyTorch).

The coordinate-wise aggregators map ``[m, ...] -> [...]`` over ``axis``.
The whole-vector ones (the geometric median by Weiszfeld iterations,
Krum) score complete worker rows: they take ``[b..., m, c...]`` with the
worker axis at ``axis``, treat the dims before it as independent batches
and the dims after it as the row's coordinates, and return
``[b..., c...]``. These are the ``backend="torch"`` execution functions
of ``core.estimator.Estimator``, the single dispatch site for robust
aggregation; call an Estimator rather than these. The median of an even
worker count averages the two middle order statistics (``torch.median``
would return the lower one).

``repro``'s ``krum`` adds ``eye * inf`` to exclude each row's distance to
itself; ``0 * inf`` is NaN there, so every score is NaN and it returns
row 0 whatever the stack. This one masks the diagonal with ``inf`` and
selects the row its docstring describes (ROADMAP.md §C).
"""
from __future__ import annotations

import warnings

import torch

__all__ = ["mean", "median", "trimmed_mean", "weiszfeld",
           "geometric_median", "krum", "vrmom", "rows", "pairwise_sq"]


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


def rows(x, axis: int = 0):
    """``[b..., m, c...]`` -> (f32 ``[B, m, C]``, batch dims, row dims):
    the batch dims before ``axis`` and the coordinates after it, each
    flattened."""
    axis %= x.ndim
    batch, rest = x.shape[:axis], x.shape[axis + 1:]
    flat = x.reshape((-1, x.shape[axis], rest.numel()))
    if flat.dtype != torch.float32:
        flat = flat.float()
    return flat, batch, rest


def pairwise_sq(flat):
    """``[B, m, C]`` -> ``[B, m, m]`` squared distances between rows, by
    direct differences (identical rows give exactly 0, which the
    Gram-matrix form ``|a|^2 + |b|^2 - 2 a.b`` does not), in blocks of
    rows so the difference tensor stays near 2^26 elements."""
    B, m, C = flat.shape
    step = max(1, (1 << 26) // max(B * m * C, 1))
    out = []
    for i in range(0, m, step):
        d = flat[:, i:i + step, None, :] - flat[:, None, :, :]
        out.append(torch.sum(d * d, dim=-1))
    return torch.cat(out, dim=1)


def weiszfeld(flat, pi, iters: int = 8, eps: float = 1e-8):
    """Weighted Weiszfeld iteration on ``[B, m, C]`` rows (``[m, C]``
    works too), prior row weights ``pi`` ``[B, m]``: the fixed point
    minimizes ``sum_i pi_i * ||y - x_i||``. ``repro``'s body: with ``pi``
    all ones it is the plain geometric median, and ``geometric_median``
    and the adaptive ``auto_gm`` share it, so the honest regime (all
    weights exactly 1.0) is bit-identical between them."""
    pi = pi.to(flat.dtype)
    y = torch.sum(flat * pi[..., None], dim=-2) / torch.sum(
        pi, dim=-1, keepdim=True)
    for _ in range(iters):
        d = torch.sqrt(torch.sum((flat - y[..., None, :]) ** 2, dim=-1)
                       + eps)
        w = pi / d
        y = torch.sum(flat * w[..., None], dim=-2) / torch.sum(
            w, dim=-1, keepdim=True)
    return y


def geometric_median(x, iters: int = 8, eps: float = 1e-8, axis: int = 0):
    """Geometric median of the worker rows by Weiszfeld iterations:
    ``[b..., m, c...]`` -> ``[b..., c...]`` in x's dtype (f32 math)."""
    flat, batch, rest = rows(x, axis)
    y = weiszfeld(flat, torch.ones(flat.shape[:2], device=flat.device),
                  iters=iters, eps=eps)
    return y.reshape(batch + rest).to(x.dtype)


def krum(x, n_byzantine: int = 0, axis: int = 0):
    """Krum: the worker row closest to its m - f - 2 nearest neighbours
    (at least one), itself excluded; ``[b..., m, c...]`` -> ``[b...,
    c...]``, ties to the lowest row."""
    flat, batch, rest = rows(x, axis)
    m = flat.shape[1]
    d2 = pairwise_sq(flat)
    eye = torch.eye(m, dtype=torch.bool, device=flat.device)
    d2 = d2.masked_fill(eye, float("inf"))
    k = max(m - n_byzantine - 2, 1)
    scores = torch.sum(torch.sort(d2, dim=-1).values[..., :k], dim=-1)
    idx = torch.argmin(scores, dim=-1)
    pick = torch.gather(flat, 1, idx[:, None, None].expand(
        -1, 1, flat.shape[2]))[:, 0]
    return pick.reshape(batch + rest).to(x.dtype)
