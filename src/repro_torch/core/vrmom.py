"""Variance-Reduced Median-of-Means (VRMOM), eq. (2), (7) and (9) of Tu,
Liu, Mao & Chen (2021), the port of ``repro.core.vrmom``.

The constants (the MAD consistency constant, the quantile levels Delta_k,
sum_k psi(Delta_k)) are host-side numpy in float64; callers cast to f32
where the estimator runs, exactly as ``repro`` does.

The estimators act coordinate-wise along a worker axis of per-machine
means ``xbar`` ``[.., m+1, ..]`` in plain PyTorch. ``vrmom`` takes the
scale of eq. (7) three ways: ``"mad"`` (MAD / ndtri(3/4) across workers),
``"master"`` (the trusted master's per-sample std over sqrt(n), the
paper's own choice) or an explicit tensor. With the MAD scale it is the
plain backend of ``core.estimator.Estimator``, whose kernel is B1 in
``kernels.vrmom``.

The theory functions (eq. 9, Theorem 4, Proposition 1) are host numpy in
float64: the test oracles of ``infer.sandwich``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# the median of an even count averages the two middle values (jnp.median)
from .aggregators import median as _median

__all__ = ["_MAD_CONST", "deltas", "psi_sum", "denominator", "mom",
           "mad_scale", "master_scale", "vrmom", "vrmom_correction_bound",
           "sigma_k_sq", "sigma_mom_sq", "vrmom_asymptotic_cov",
           "mom_asymptotic_cov"]

_MAD_CONST = 0.6744897501960817  # ndtri(0.75)


def _ndtri_np(p):
    """Inverse normal CDF, pure numpy (host-side)."""
    try:
        from scipy.special import ndtri as _sndtri

        return _sndtri(p)
    except ImportError:  # pragma: no cover - scipy-free fallback (Acklam)
        p = np.asarray(p, dtype=np.float64)
        a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
             1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
        b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
             6.680131188771972e01, -1.328068155288572e01]
        c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
             -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
        d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
             3.754408661907416e00]
        plow, phigh = 0.02425, 1 - 0.02425
        x = np.empty_like(p)
        lo = p < plow
        hi = p > phigh
        mid = ~(lo | hi)
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        return x


@functools.lru_cache(maxsize=64)
def _deltas_cached(K: int):
    taus = np.arange(1, K + 1, dtype=np.float64) / (K + 1)
    return np.asarray(_ndtri_np(taus), dtype=np.float64)


def deltas(K: int) -> np.ndarray:
    """Delta_k = ndtri(k/(K+1)) for k = 1..K, as f32 (float64, then cast)."""
    return _deltas_cached(K).astype(np.float32)


@functools.lru_cache(maxsize=64)
def psi_sum(K: int) -> float:
    """sum_k psi(Delta_k) as a python float (float64)."""
    d = _deltas_cached(K)
    return float(np.sum(np.exp(-0.5 * d * d) / np.sqrt(2.0 * np.pi)))


def denominator(m: int, K: int) -> np.float32:
    """The f32 denominator ``m * psi_sum(K)`` of the VRMOM correction:
    the product in float64, one cast to f32 — the value ``repro``'s f32
    arithmetic sees for its python-float operand."""
    return np.float32(m * psi_sum(K))


# ---------------------------------------------------------------------------
# The estimators (plain PyTorch)
# ---------------------------------------------------------------------------

def _f32(value, like):
    """A 0-d tensor: dividing by it is an IEEE division on the card too,
    where a python float divisor becomes a reciprocal multiply. Filled on
    the device (no host-to-device copy, so a CUDA graph can capture it)."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=64)
def _deltas_on(K: int, device, dtype):
    """The K deltas on ``device``, copied there once (the first call of a
    captured step runs eagerly, so a replay never copies)."""
    return torch.from_numpy(_deltas_cached(K)).to(device, dtype)


def mom(xbar, axis: int = 0):
    """Median-of-means, eq. (2): coordinate-wise median over ``axis``."""
    return _median(xbar, axis)


def mad_scale(xbar, axis: int = 0, center=None):
    """Robust scale of the per-machine means: MAD / ndtri(3/4)."""
    if center is None:
        center = _median(xbar, axis)
    mad = _median(torch.abs(xbar - center.unsqueeze(axis)), axis)
    return mad / _f32(_MAD_CONST, mad)


def master_scale(master_samples, axis: int = 0):
    """Paper-faithful scale: the master's per-sample std / sqrt(n).

    ``master_samples``: raw per-sample values on the trusted master, its
    ``n`` samples along ``axis``. Returns ``sigma_hat / sqrt(n)`` (the std
    with ddof 0, as ``jnp.std``)."""
    n = master_samples.shape[axis]
    sigma = torch.std(master_samples, dim=axis, correction=0)
    return sigma / torch.sqrt(_f32(float(n), sigma))


def _resolve_scale(xbar, axis, scale, master_samples, mu_hat):
    if isinstance(scale, str):
        if scale == "mad":
            return mad_scale(xbar, axis=axis, center=mu_hat)
        if scale == "master":
            if master_samples is None:
                raise ValueError("scale='master' requires master_samples")
            return master_scale(master_samples, axis=axis)
        raise ValueError(f"unknown scale {scale!r}")
    return torch.as_tensor(scale, device=xbar.device)


def vrmom(xbar, K: int = 10, axis: int = 0, scale="mad",
          master_samples=None, eps: float = 1e-12):
    """VRMOM estimator, eq. (7) of the paper (``repro.core.vrmom.vrmom``).

    Args:
      xbar: per-machine means, worker axis ``axis`` of size m+1.
      K: number of quantile levels (tau_k = k/(K+1)).
      scale: 'mad' | 'master' | explicit mean-level scale ``s``.
      master_samples: raw master samples, their n samples along ``axis``,
        required iff scale='master'.
      eps: guards division when the scale is ~0 (constant inputs).

    Returns the estimate with the worker axis removed, in xbar's dtype
    (f32 math for f32 and narrower inputs). With the MAD scale this is
    the Estimator's ``"torch"`` backend; the divisions are IEEE, as in B1.
    """
    dtype = xbar.dtype
    x = xbar.float() if dtype in (torch.float16, torch.bfloat16) else xbar
    m1 = x.shape[axis]
    mu_hat = _median(x, axis)
    s = _resolve_scale(x, axis, scale, master_samples, mu_hat)
    s = torch.broadcast_to(s.to(x.dtype), mu_hat.shape)
    d = _deltas_on(K, x.device, x.dtype)
    z = (x - mu_hat.unsqueeze(axis)) / torch.clamp_min(s, eps).unsqueeze(axis)
    # count via comparisons (exact; avoids ceil edge cases at Phi in {0,1})
    counts = torch.sum(z.unsqueeze(-1) <= d, dim=-1).to(x.dtype)
    total = torch.sum(counts - K / 2.0, dim=axis)
    out = mu_hat - s * total / _f32(denominator(m1, K), s)
    # a degenerate scale (all-equal inputs) makes the correction 0/0
    return torch.where(s <= eps, mu_hat, out).to(dtype)


def vrmom_correction_bound(K: int) -> float:
    """Deterministic bound: |vrmom - mom| <= s * (K/2) / sum_k psi(Delta_k).

    Follows from |sum_k 1(.) - K/2| <= K/2 per machine (Remark 2)."""
    return (K / 2.0) / psi_sum(K)


# ---------------------------------------------------------------------------
# Theory: asymptotic variances (eq. 9 and Minsker 2019 for MOM)
# ---------------------------------------------------------------------------

def sigma_k_sq(K: int) -> float:
    """sigma_K^2 / sigma^2 from eq. (9). -> pi/3 as K -> inf; K=1 gives pi/2."""
    taus = np.arange(1, K + 1, dtype=np.float64) / (K + 1)
    t1 = taus[:, None]
    t2 = taus[None, :]
    num = np.sum(np.minimum(t1, t2) * (1.0 - np.maximum(t1, t2)))
    den = float(psi_sum(K)) ** 2
    return float(num / den)


def sigma_mom_sq() -> float:
    """MOM asymptotic variance factor: pi/2 (Minsker 2019)."""
    return math.pi / 2.0


# ---------------------------------------------------------------------------
# Theorem 4 / Proposition 1: multivariate asymptotic covariance matrices
# ---------------------------------------------------------------------------

def _phi2_cdf_grid(a, b, rho, n_grid: int = 2001, lim: float = 8.0):
    """P(Z1 <= a, Z2 <= b) for standard bivariate normal with corr rho,
    via P = int_{-lim}^{a} phi(z) Phi((b - rho z)/sqrt(1-rho^2)) dz
    (host-side numpy quadrature; exact enough for the tests)."""
    if abs(rho) >= 1.0 - 1e-12:
        if rho > 0:  # P(Z <= min(a, b))
            return 0.5 * (1 + math.erf(min(a, b) / math.sqrt(2.0)))
        # rho = -1: P(Z <= a, -Z <= b) = P(-b <= Z <= a)
        return max(0.0, 0.5 * (math.erf(a / math.sqrt(2))
                               + math.erf(b / math.sqrt(2))))
    z = np.linspace(-lim, min(a, lim), n_grid)
    phi = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
    arg = (b - rho * z) / math.sqrt(1.0 - rho * rho)
    Phi = 0.5 * (1.0 + np.vectorize(math.erf)(arg / np.sqrt(2.0)))
    return float(np.trapezoid(phi * Phi, z))


def vrmom_asymptotic_cov(Sigma, K: int):
    """The matrix C of Theorem 4 (eq. 13/14): sqrt(N)(mu_bar - mu) -> N(0, C).

    Sigma: [p, p] covariance of X. Host-side numpy (theory utility).
    """
    Sigma = np.asarray(Sigma, dtype=np.float64)
    p = Sigma.shape[0]
    sd = np.sqrt(np.diag(Sigma))
    corr = Sigma / np.outer(sd, sd)
    d = _deltas_cached(K)
    taus = np.arange(1, K + 1, dtype=np.float64) / (K + 1)
    den = psi_sum(K) ** 2
    C = np.zeros((p, p))
    for l1 in range(p):
        for l2 in range(l1, p):
            rho = float(np.clip(corr[l1, l2], -1.0, 1.0))
            acc = 0.0
            for k1 in range(K):
                for k2 in range(K):
                    t12 = _phi2_cdf_grid(d[k1], d[k2], rho)
                    acc += t12 - taus[k1] * taus[k2]
            C[l1, l2] = C[l2, l1] = acc / den * sd[l1] * sd[l2]
    return C


def mom_asymptotic_cov(Sigma):
    """C_MOM of Proposition 1 (eq. 17)."""
    Sigma = np.asarray(Sigma, dtype=np.float64)
    p = Sigma.shape[0]
    sd = np.sqrt(np.diag(Sigma))
    corr = Sigma / np.outer(sd, sd)
    C = np.zeros((p, p))
    for l1 in range(p):
        for l2 in range(l1, p):
            rho = float(np.clip(corr[l1, l2], -1.0, 1.0))
            t = _phi2_cdf_grid(0.0, 0.0, rho)
            C[l1, l2] = C[l2, l1] = (2 * np.pi * t - np.pi / 2) \
                * sd[l1] * sd[l2]
    return C
