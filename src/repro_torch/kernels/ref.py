"""Plain PyTorch oracles for the aggregation and attention kernels.

The reference semantics the CUDA kernels must match, as in ``repro``'s
``kernels/ref.py``: coordinate-wise mean / MOM / trimmed mean / VRMOM over
the leading (worker) axis with the MAD scale, and plain softmax
attention. The median of an even worker count is the AVERAGE of the two
middle order statistics (numpy convention) — ``torch.median`` returns the
lower one, so it is never used here. Dispatch policy lives in
``core.estimator.Estimator``; these are execution entry points.
"""
from __future__ import annotations

import torch

from ..core.vrmom import _MAD_CONST, deltas, denominator


def _median_sorted(xs):
    m = xs.shape[0]
    return 0.5 * (xs[(m - 1) // 2] + xs[m // 2])


def ref_mean(x):
    """x: [M, C] -> [C] coordinate-wise mean (f32 accumulation)."""
    return torch.mean(x.float(), dim=0).to(x.dtype)


def ref_mom(x):
    """x: [M, C] -> [C] coordinate-wise median (two middle values averaged)."""
    xs = torch.sort(x.float(), dim=0).values
    return _median_sorted(xs).to(x.dtype)


def ref_trimmed_mean(x, beta: float = 0.1):
    """x: [M, C] -> [C] coordinate-wise beta-trimmed mean; trims
    ``int(beta*M)`` order statistics at each end (the caller validates
    that the trim count is non-zero)."""
    m = x.shape[0]
    k = int(beta * m)
    xs = torch.sort(x.float(), dim=0).values
    return torch.mean(xs[k: m - k if m - k > k else k + 1], dim=0).to(x.dtype)


def f32_scalar(value, device):
    """A 0-d f32 tensor on ``device``. Dividing by it is a true IEEE
    division on every device; dividing a CUDA tensor by a python float
    multiplies by its reciprocal instead, which can round differently.
    Filled on the device: no host-to-device copy."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def ref_vrmom(x, K: int = 10, eps: float = 1e-12):
    """x: [M, C] -> [C] VRMOM (eq. 7) with the MAD scale; quantile counts
    accumulate one level at a time, so no [M, C, K] tensor exists."""
    xf = x.float()
    M = xf.shape[0]
    med = _median_sorted(torch.sort(xf, dim=0).values)
    mad = _median_sorted(torch.sort(torch.abs(xf - med[None]), dim=0).values)
    s = mad / f32_scalar(_MAD_CONST, x.device)
    z = (xf - med[None]) / torch.clamp_min(s, eps)[None]
    counts = torch.zeros_like(z)
    for d in deltas(K).tolist():
        counts = counts + (z <= d).float()
    total = torch.sum(counts - K / 2.0, dim=0)
    out = med - s * total / f32_scalar(denominator(M, K), x.device)
    return torch.where(s <= eps, med, out).to(x.dtype)


def ref_attention(q, k, v, causal: bool = True):
    """Plain softmax attention. q: [B,S,H,dh], k/v: [B,T,H,dh]."""
    dh = q.shape[-1]
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / (dh ** 0.5)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)
