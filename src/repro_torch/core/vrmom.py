"""VRMOM constants: the MAD consistency constant, the quantile levels
Delta_k and sum_k psi(Delta_k) of eq. (7) (Tu, Liu, Mao & Chen, 2021).

Host-side numpy only, computed in float64; callers cast to f32 where the
estimator runs, exactly as ``repro`` does. The estimator itself lives in
``core.aggregators`` (plain PyTorch) and ``kernels.vrmom`` (CUDA).
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["_MAD_CONST", "deltas", "psi_sum"]

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
