"""Plug-in sandwich covariance and confidence intervals for RCSL, the port
of ``repro.infer.sandwich``.

At the RCSL fixed point the estimator solves the robustly aggregated
estimating equation ``gbar(theta_hat) = 0``, hence (Theorem 4)

    sqrt(N) (theta_hat - theta*)  ->  N(0,  H^{-1} C(Sigma_g) H^{-1})

with ``H`` the population Hessian, ``Sigma_g`` the per-sample gradient
covariance and ``C`` the aggregator's covariance transform: Theorem 4 for
VRMOM, Proposition 1 for MOM, the identity for the mean.

1. *Per-machine statistics* (:func:`machine_stats`): each machine's local
   Hessian and per-sample-gradient moments; Byzantine machines report
   garbage (:func:`corrupt_stats`).
2. *Robust plug-in* (:func:`robust_moments`): the stacked statistics are
   aggregated coordinate-wise with an ``Estimator`` over the machine axis
   (the symmetric stacks as their upper triangles), which on the card is
   B1 on ``[m+1, R·p(p+1)/2]`` and ``[m+1, R·p]`` stacks.
3. *Sandwich + factor* (:func:`sandwich_cov`): ``Xi = H^{-1} C H^{-1}``
   with ``C`` from :func:`vrmom_cov_factor`, built on :func:`bvn_cdf`, a
   fixed-node Gauss-Legendre bivariate-normal CDF (the host numpy
   ``core.vrmom.vrmom_asymptotic_cov`` is its test oracle).
4. *Intervals* (:func:`confidence_intervals`): ``theta_l ± z sqrt(Xi_ll /
   N)``, and Bonferroni simultaneous bands.

Every function takes optional leading replication axes (``theta [R, p]``,
shards ``[R, m+1, n, p]``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.special import ndtr, ndtri

from ..core import attacks as _attacks
from ..core.estimator import Estimator
from ..core.vrmom import _deltas_cached, _ndtri_np, psi_sum, sigma_k_sq
from ..dist.robust_reduce import aggregate_symmetric_stacked

__all__ = [
    "bvn_cdf",
    "vrmom_cov_factor",
    "mom_cov_factor",
    "cov_factor",
    "trimmed_mean_variance_factor",
    "contamination_inflation",
    "MachineStats",
    "machine_stats",
    "corrupt_stats",
    "robust_moments",
    "sandwich_cov",
    "confidence_intervals",
    "CIResult",
    "InferenceResult",
    "infer",
]

# Fixed Gauss-Legendre rule on [0, 1]; 24 nodes give ~1e-7 absolute
# accuracy on the (smooth, bounded) bvn integrand.
_GL_X, _GL_W = np.polynomial.legendre.leggauss(24)
_GL_X01 = ((_GL_X + 1.0) / 2.0).astype(np.float32)
_GL_W01 = (_GL_W / 2.0).astype(np.float32)

_RHO_EDGE = 1.0 - 1e-6


def bvn_cdf(a, b, rho):
    """Standard bivariate normal CDF ``P(Z1 <= a, Z2 <= b)`` in f32.

    The arcsin substitution of Drezner-Wesolowsky's single integral,

        P = Phi(a) Phi(b) + (1/2pi) int_0^{asin(rho)}
              exp(-(a^2 - 2 a b sin t + b^2) / (2 cos^2 t)) dt,

    evaluated with the fixed 24-node Gauss-Legendre rule; it broadcasts.
    ``|rho| -> 1`` is exact (``Phi(min(a,b))`` / ``max(0,
    Phi(a)+Phi(b)-1)``), which every correlation-matrix diagonal hits.
    """
    ref = next((t for t in (a, b, rho) if isinstance(t, torch.Tensor)), None)
    dev = ref.device if ref is not None else None
    a, b, rho = torch.broadcast_tensors(
        *(torch.as_tensor(t, dtype=torch.float32, device=dev)
          for t in (a, b, rho)))
    gx = torch.from_numpy(_GL_X01).to(a.device)
    gw = torch.from_numpy(_GL_W01).to(a.device)
    r = torch.clamp(rho, -_RHO_EDGE, _RHO_EDGE)
    s = torch.arcsin(r).unsqueeze(-1)                  # [..., 1]
    theta = s * gx                                     # [..., Q]
    sin_t = torch.sin(theta)
    cos2_t = torch.clamp_min(torch.cos(theta) ** 2, 1e-12)
    a_e, b_e = a.unsqueeze(-1), b.unsqueeze(-1)
    integrand = torch.exp(-(a_e * a_e - 2.0 * a_e * b_e * sin_t + b_e * b_e)
                          / (2.0 * cos2_t))
    quad = torch.sum(gw * integrand, dim=-1) * s[..., 0]
    base = ndtr(a) * ndtr(b) + quad / (2.0 * math.pi)
    hi = ndtr(torch.minimum(a, b))                     # rho -> +1
    lo = torch.clamp_min(ndtr(a) + ndtr(b) - 1.0, 0.0)  # rho -> -1
    return torch.where(rho >= _RHO_EDGE, hi,
                       torch.where(rho <= -_RHO_EDGE, lo, base))


def _corr_parts(Sigma, eps=1e-12):
    """(sd_l sd_l', the correlation matrix). Its diagonal is set to 1:
    Sigma_ll / sqrt(Sigma_ll)^2 rounds below 1 for some Sigma_ll in f32,
    where MOM's arcsin(corr) falls 3.45e-4 or 4.88e-4 short of pi/2
    (``repro`` takes the rounded value; ROADMAP.md §C)."""
    Sigma = torch.as_tensor(Sigma).float()
    var = torch.clamp_min(torch.diagonal(Sigma, dim1=-2, dim2=-1), eps)
    sd = torch.sqrt(var)
    outer = sd.unsqueeze(-1) * sd.unsqueeze(-2)
    corr = torch.clamp(Sigma / outer, -1.0, 1.0)
    torch.diagonal(corr, dim1=-2, dim2=-1).fill_(1.0)
    return outer, corr


def vrmom_cov_factor(Sigma, K: int = 10):
    """Theorem 4 (eq. 13/14) asymptotic covariance ``C`` of VRMOM:
    ``sqrt(N)(vrmom - mu) -> N(0, C)`` for machine means with per-sample
    covariance ``Sigma`` ``[.., p, p]``. Evaluated on the upper triangle
    and mirrored (corr is symmetric, so the full matrix has the same
    values); the host ``core.vrmom.vrmom_asymptotic_cov`` is its oracle.
    """
    outer, corr = _corr_parts(Sigma)
    p = corr.shape[-1]
    iu = torch.triu_indices(p, p, device=corr.device)
    rho = corr[..., iu[0], iu[1]]                       # [.., T]
    d = torch.from_numpy(_deltas_cached(K)).float().to(corr.device)
    taus = torch.arange(1, K + 1, dtype=torch.float32,
                        device=corr.device) / (K + 1)
    P = bvn_cdf(d[:, None], d[None, :], rho[..., None, None])  # [.., T, K, K]
    acc = torch.sum(P - taus[:, None] * taus[None, :], dim=(-2, -1))
    tri = torch.zeros(corr.shape, dtype=torch.float32, device=corr.device)
    tri[..., iu[0], iu[1]] = acc
    tri = tri + torch.triu(tri, 1).transpose(-1, -2)
    return tri / (psi_sum(K) ** 2) * outer


def mom_cov_factor(Sigma):
    """Proposition 1 (eq. 17) asymptotic covariance of MOM, closed form:
    ``2 pi P(0,0;rho) - pi/2`` is ``arcsin(rho)``. The diagonal recovers
    Minsker's ``pi/2``."""
    outer, corr = _corr_parts(Sigma)
    return torch.arcsin(corr) * outer


def trimmed_mean_variance_factor(beta: float) -> float:
    """Asymptotic variance of the symmetric ``beta``-trimmed mean of N(0,1)
    samples (host float):

        [ int_{z_b}^{z_{1-b}} z^2 phi(z) dz + 2 b z_b^2 ] / (1-2b)^2

    with ``z_b = Phi^{-1}(beta)``.
    """
    if not 0.0 <= beta < 0.5:
        raise ValueError(f"beta must be in [0, 0.5), got {beta}")
    if beta == 0.0:
        return 1.0
    zb = float(np.abs(_ndtri_np(beta)))
    phi = math.exp(-0.5 * zb * zb) / math.sqrt(2.0 * math.pi)
    # int_{-z}^{z} t^2 phi(t) dt = (2 Phi(z) - 1) - 2 z phi(z)
    core = (1.0 - 2.0 * beta) - 2.0 * zb * phi
    return (core + 2.0 * beta * zb * zb) / (1.0 - 2.0 * beta) ** 2


def cov_factor(Sigma, est: Estimator):
    """The ``C(Sigma)`` transform matching an aggregation method:
    ``vrmom`` -> Theorem 4, ``median``/``mom`` -> Proposition 1, ``mean``
    -> identity, ``trimmed_mean`` -> winsorized-IF scaling; the adaptive
    methods their honest-regime asymptotics (``vrmom_adaptive`` ->
    Theorem 4, ``auto_gm`` -> Proposition 1). Other estimators have no
    normality theory in the paper and are rejected."""
    if est.method in ("vrmom", "vrmom_adaptive"):
        return vrmom_cov_factor(Sigma, K=est.K)
    if est.method in ("median", "mom", "auto_gm"):
        return mom_cov_factor(Sigma)
    if est.method == "trimmed_mean":
        return (trimmed_mean_variance_factor(est.beta)
                * torch.as_tensor(Sigma).float())
    if est.method == "mean":
        return torch.as_tensor(Sigma).float()
    raise ValueError(
        f"no asymptotic-normality result for estimator {est.method!r}; "
        "inference supports vrmom, median/mom, trimmed_mean, mean, and "
        "the adaptive tier (auto_gm, vrmom_adaptive)")


def contamination_inflation(alpha: float,
                            est: Union[str, Estimator] = "vrmom") -> float:
    """Finite-alpha variance inflation of the CIs (``repro``'s DESIGN.md
    §9): the contaminated over the clean asymptotic variance at the worst
    symmetric contamination, from first-order influence functions. With
    ``a = pi/2`` (median IF variance), ``b = sigma_K^2`` and ``c = -pi/4``:

        [(1-al) ((1-al)^{-2} a + b + 2 (1-al)^{-1} c)
         + al ((1-al)^{-1} sqrt(pi/2) + K/(2 psi_sum))^2] / sigma_K^2 ;

    ``(1-al)^{-2}`` for the median (and trimmed mean, auto_gm), 1 for the
    mean, 1 at ``al = 0``.
    """
    if not 0.0 <= alpha < 0.5:
        raise ValueError(f"alpha must be in [0, 0.5), got {alpha}")
    if alpha == 0.0:
        return 1.0
    est = Estimator.coerce(est)
    g = 1.0 / (1.0 - alpha)
    if est.method in ("median", "mom", "trimmed_mean", "auto_gm"):
        return g * g
    if est.method == "mean":
        return 1.0
    a = math.pi / 2.0
    b = sigma_k_sq(est.K)
    c = -math.pi / 4.0
    honest = g * g * a + b + 2.0 * g * c
    garbage = (g * math.sqrt(a) + est.K / (2.0 * psi_sum(est.K))) ** 2
    return ((1.0 - alpha) * honest + alpha * garbage) / b


# ---------------------------------------------------------------------------
# Per-machine statistics and their robust aggregation
# ---------------------------------------------------------------------------


class MachineStats(NamedTuple):
    """Stacked per-machine inference statistics (machine axis before the
    statistic's own axes; leading axes are replications).

    hessian: ``[.., m+1, p, p]`` local Hessians at theta_hat.
    grad1:   ``[.., m+1, p]``    local mean per-sample gradient.
    grad2:   ``[.., m+1, p, p]`` local second moment ``E_n[g g^T]``.
    n:       per-machine sample size (python int).
    """

    hessian: torch.Tensor
    grad1: torch.Tensor
    grad2: torch.Tensor
    n: int


def machine_stats(problem, theta, shards) -> MachineStats:
    """Every machine's (Hessian, gradient-moment) report at ``theta``
    (``[.., p]``, broadcast over the machines)."""
    th = theta.unsqueeze(-2)
    H = problem.local_hessian(th, shards.X, shards.Y)
    g1, g2 = problem.local_moments(th, shards.X, shards.Y)
    return MachineStats(H, g1, g2, int(shards.X.shape[-2]))


def corrupt_stats(generator, stats: MachineStats, mask,
                  attack: str) -> MachineStats:
    """Byzantine machines report arbitrary statistics: a ``core.attacks``
    transform of each stacked leaf (rows selected by ``mask``; row 0, the
    master, never is)."""
    return MachineStats(
        hessian=_attacks.attack_stack(attack, generator, stats.hessian, mask,
                                      axis=stats.hessian.ndim - 3),
        grad1=_attacks.attack_stack(attack, generator, stats.grad1, mask,
                                    axis=stats.grad1.ndim - 2),
        grad2=_attacks.attack_stack(attack, generator, stats.grad2, mask,
                                    axis=stats.grad2.ndim - 3),
        n=stats.n,
    )


def robust_moments(stats: MachineStats, est: Union[str, Estimator] = "vrmom"):
    """Aggregate stacked statistics into plug-in ``(H_hat, Sigma_hat)``:
    coordinate-wise over the machine axis, the symmetric stacks through
    ``dist.robust_reduce.aggregate_symmetric_stacked``, then ``Sigma_hat =
    E[gg^T] - g1 g1^T``. Three Estimator calls; on the card each is one
    launch of B1 (``"auto"``)."""
    est = Estimator.coerce(est).require_stackable(
        "plug-in covariance aggregation (repro_torch.infer)")
    H = aggregate_symmetric_stacked(stats.hessian, est)
    g2 = aggregate_symmetric_stacked(stats.grad2, est)
    g1 = est.apply(stats.grad1.float(), axis=stats.grad1.ndim - 2)
    Sigma = g2 - g1.unsqueeze(-1) * g1.unsqueeze(-2)
    return H, Sigma


def sandwich_cov(H, Sigma, est: Union[str, Estimator] = "vrmom"):
    """``Xi = H^{-1} C(Sigma) H^{-1}``: the asymptotic covariance of
    ``sqrt(N)(theta_hat - theta*)`` for an RCSL run aggregated with
    ``est``. ``H`` is symmetrized before the solves."""
    est = Estimator.coerce(est)
    C = cov_factor(Sigma, est)
    Hs = (0.5 * (H + H.transpose(-1, -2))).float()
    HinvC = torch.linalg.solve(Hs, C)
    return torch.linalg.solve(Hs, HinvC.transpose(-1, -2)).transpose(-1, -2)


# ---------------------------------------------------------------------------
# Intervals
# ---------------------------------------------------------------------------


class CIResult(NamedTuple):
    """Per-coordinate confidence intervals at a nominal level.

    lower/upper: ``[.., p]`` bounds; se: ``[.., p]`` standard errors
    ``sqrt(Xi_ll / N)``; z: the critical value used (Bonferroni-adjusted
    when simultaneous).
    """

    lower: torch.Tensor
    upper: torch.Tensor
    se: torch.Tensor
    level: float
    z: torch.Tensor


def confidence_intervals(theta, Xi, N: int, level: float = 0.95,
                         simultaneous: bool = False) -> CIResult:
    """Normal plug-in CIs ``theta_l ± z sqrt(Xi_ll / N)``;
    ``simultaneous=True`` applies the Bonferroni correction
    ``z_{1 - (1-level)/(2p)}``."""
    theta = torch.as_tensor(theta)
    p = theta.shape[-1]
    q = (1.0 - level) / (p if simultaneous else 1.0)
    z = ndtri(torch.tensor(1.0 - q / 2.0, dtype=torch.float32,
                           device=theta.device))
    se = torch.sqrt(torch.clamp_min(torch.diagonal(Xi, dim1=-2, dim2=-1),
                                    0.0) / N)
    half = z * se
    return CIResult(lower=theta - half, upper=theta + half, se=se,
                    level=level, z=z)


class InferenceResult(NamedTuple):
    """Everything the plug-in inference layer produces for an RCSL run."""

    theta: torch.Tensor   # [.., p] point estimate the CIs are centred on
    ci: CIResult          # per-coordinate (or simultaneous) intervals
    cov: torch.Tensor     # [.., p, p] sandwich Xi (covariance of sqrt(N) error)
    H: torch.Tensor       # [.., p, p] robust plug-in Hessian
    Sigma: torch.Tensor   # [.., p, p] robust plug-in gradient covariance
    N: int                # total sample size (m+1) * n


def infer(problem, shards, theta, estimator: Union[str, Estimator] = "vrmom",
          K: int = 10, level: float = 0.95, simultaneous: bool = False,
          alpha: float = 0.0, attack: str = "none",
          generator: Optional[torch.Generator] = None,
          assumed_alpha: Optional[float] = None) -> InferenceResult:
    """Plug-in inference for an RCSL point estimate (``repro.infer.infer``).

    ``estimator`` names the aggregation the point estimate was computed
    with: it aggregates the per-machine statistics (backend ``"auto"``
    for a name, B1 on the card) and picks the factor ``C``. ``alpha``
    scales the sandwich by :func:`contamination_inflation` and, with
    ``attack``/``generator``, corrupts the statistics of floor(alpha*m)
    machines before aggregation. ``assumed_alpha`` splits the two roles:
    corruption at the true ``alpha``, inflation at the analyst's
    assumption (``None``: the true alpha).
    """
    est = Estimator.coerce(estimator)
    if isinstance(estimator, str) and est.method in ("vrmom",
                                                     "vrmom_adaptive"):
        est = est._replace(K=K)
    stats = machine_stats(problem, theta, shards)
    m1 = stats.hessian.shape[-3]
    if attack != "none" and alpha > 0.0:
        if generator is None:
            raise ValueError("corrupting stats (attack != 'none') needs a "
                             "generator")
        mask = _attacks.byzantine_mask(m1, alpha, device=theta.device)
        stats = corrupt_stats(generator, stats, mask, attack)
    H, Sigma = robust_moments(stats, est)
    infl_alpha = alpha if assumed_alpha is None else assumed_alpha
    Xi = sandwich_cov(H, Sigma, est) * contamination_inflation(infl_alpha,
                                                               est)
    N = m1 * stats.n
    ci = confidence_intervals(theta, Xi, N, level=level,
                              simultaneous=simultaneous)
    return InferenceResult(theta=theta, ci=ci, cov=Xi, H=H, Sigma=Sigma, N=N)
