"""Robust CSL (RCSL) — Algorithm 1 of the paper, the port of
``repro.core.rcsl``.

One round (master H0 = shard 0):
  1. broadcast theta; every machine j computes g_j = (1/n) sum grad f(X_i, theta)
  2. Byzantine machines send arbitrary values instead
  3. master aggregates coordinate-wise with VRMOM (or any aggregator)
  4. master minimizes the CSL surrogate
        (1/n) sum_{i in H0} f(X_i, theta) - <g_0 - g_bar, theta>

Every function takes an optional leading replication axis: shards
``X [R, m+1, n, p]``, ``Y [R, m+1, n]`` run R independent replications at
once, and ``[m+1, n, p]`` is the one-replication case of ``repro``'s
signatures. The Problems take ``theta [.., p]``, ``X [.., n, p]`` and
``Y [.., n]`` with leading axes that broadcast. A coordinate-wise
aggregation of the ``[R, m+1, p]`` gradients is one ``[m+1, R·p]`` stack
for the Estimator, which on the card is one launch of B1. A
``torch.Generator`` on the shards' device takes the place of the PRNG key.

Linear regression has the paper's closed form; logistic regression uses
Newton; ``GenericProblem`` uses ``torch.func`` (grad, vmap, hessian) and
gradient descent.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import attacks
from .estimator import Estimator
from .vrmom import vrmom as _vrmom

__all__ = ["Shards", "LinearRegressionProblem", "LogisticRegressionProblem",
           "GenericProblem", "aggregate_gradients", "rcsl", "make_shards",
           "paper_theta_star"]


class Shards(NamedTuple):
    """Data evenly split over m+1 machines. X: [.., m+1, n, p], Y: [.., m+1, n]."""

    X: torch.Tensor
    Y: torch.Tensor


def _mv(X, theta):
    """X theta: [.., n, p] x [.., p] -> [.., n]."""
    return (X @ theta.unsqueeze(-1)).squeeze(-1)


def _tmv(X, r):
    """X^T r: [.., n, p] x [.., n] -> [.., p]."""
    return (X.transpose(-1, -2) @ r.unsqueeze(-1)).squeeze(-1)


def _gram(X, w=None):
    """X^T diag(w) X: [.., n, p] -> [.., p, p]."""
    Xw = X if w is None else X * w.unsqueeze(-1)
    return Xw.transpose(-1, -2) @ X


def _eye(p, like):
    return torch.eye(p, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearRegressionProblem:
    """f(x, theta) = (y - x^T theta)^2  (paper Section 4.2)."""

    ridge: float = 0.0

    def local_grad(self, theta, X, Y):
        resid = _mv(X, theta) - Y  # [.., n]
        return 2.0 * _tmv(X, resid) / X.shape[-2]

    def per_sample_grads(self, theta, X, Y):
        resid = _mv(X, theta) - Y
        return 2.0 * X * resid.unsqueeze(-1)  # [.., n, p]

    def local_hessian(self, theta, X, Y):
        """Local loss Hessian 2 X^T X / n (the ridge is a solver aid,
        not part of the inferential target, so it is excluded)."""
        return 2.0 * _gram(X) / X.shape[-2]

    def local_moments(self, theta, X, Y):
        """(mean, second moment) of the per-sample gradients, closed
        form: g_i = 2 x_i r_i, so E_n[g g^T] = 4 X^T diag(r^2) X / n."""
        n = X.shape[-2]
        resid = _mv(X, theta) - Y
        g1 = 2.0 * _tmv(X, resid) / n
        g2 = 4.0 * _gram(X, resid * resid) / n
        return g1, g2

    def init_theta(self, X, Y):
        n, p = X.shape[-2:]
        A = _gram(X) / n + self.ridge * _eye(p, X)
        return torch.linalg.solve(A, _tmv(X, Y) / n)

    def master_solve(self, theta, X, Y, linear_term):
        """argmin (1/n) sum (y - x^T th)^2 - <linear_term, th> (closed form)."""
        n, p = X.shape[-2:]
        A = 2.0 * _gram(X) / n + self.ridge * _eye(p, X)
        b = 2.0 * _tmv(X, Y) / n + linear_term
        return torch.linalg.solve(A, b)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionProblem:
    """f(x, theta) = log(1 + exp(x^T th)) - y x^T th; Newton master solve."""

    newton_iters: int = 25
    ridge: float = 1e-8

    def local_grad(self, theta, X, Y):
        mu = torch.sigmoid(_mv(X, theta))
        return _tmv(X, mu - Y) / X.shape[-2]

    def per_sample_grads(self, theta, X, Y):
        mu = torch.sigmoid(_mv(X, theta))
        return X * (mu - Y).unsqueeze(-1)

    def local_hessian(self, theta, X, Y):
        mu = torch.sigmoid(_mv(X, theta))
        return _gram(X, mu * (1.0 - mu)) / X.shape[-2]

    def local_moments(self, theta, X, Y):
        n = X.shape[-2]
        d = torch.sigmoid(_mv(X, theta)) - Y
        return _tmv(X, d) / n, _gram(X, d * d) / n

    def init_theta(self, X, Y):
        zero = X.new_zeros(X.shape[:-2] + X.shape[-1:])
        return self._newton(zero, X, Y, zero)

    def master_solve(self, theta, X, Y, linear_term):
        return self._newton(theta, X, Y, linear_term)

    def _newton(self, theta, X, Y, linear_term):
        n, p = X.shape[-2:]
        for _ in range(self.newton_iters):
            mu = torch.sigmoid(_mv(X, theta))
            g = _tmv(X, mu - Y) / n - linear_term
            H = _gram(X, mu * (1.0 - mu)) / n + self.ridge * _eye(p, X)
            theta = theta - torch.linalg.solve(H, g)
        return theta


@dataclasses.dataclass(frozen=True)
class GenericProblem:
    """Any differentiable per-sample loss ``loss_fn(theta, x, y)`` written
    in PyTorch; ``torch.func`` supplies the derivatives."""

    loss_fn: Callable
    master_steps: int = 200
    lr: float = 0.1

    def _mean_loss(self, theta, X, Y):
        from torch.func import vmap

        return torch.mean(vmap(self.loss_fn, in_dims=(None, 0, 0))(theta, X, Y))

    def _batched(self, fn, theta, X, Y):
        """fn on one shard (theta [p], X [n, p], Y [n]), vmapped over the
        broadcast leading axes."""
        from torch.func import vmap

        n, p = X.shape[-2:]
        lead = torch.broadcast_shapes(theta.shape[:-1], X.shape[:-2],
                                      Y.shape[:-1])
        th = theta.expand(lead + (p,)).reshape(-1, p)
        out = vmap(fn)(th, X.expand(lead + (n, p)).reshape(-1, n, p),
                       Y.expand(lead + (n,)).reshape(-1, n))
        return out.reshape(lead + out.shape[1:])

    def _grad1(self, theta, X, Y):
        from torch.func import grad

        return grad(self._mean_loss)(theta, X, Y)

    def _per_sample1(self, theta, X, Y):
        from torch.func import grad, vmap

        return vmap(grad(self.loss_fn), in_dims=(None, 0, 0))(theta, X, Y)

    def _hessian1(self, theta, X, Y):
        from torch.func import hessian

        return hessian(self._mean_loss)(theta, X, Y)

    def local_grad(self, theta, X, Y):
        return self._batched(self._grad1, theta, X, Y)

    def per_sample_grads(self, theta, X, Y):
        return self._batched(self._per_sample1, theta, X, Y)

    def local_hessian(self, theta, X, Y):
        return self._batched(self._hessian1, theta, X, Y)

    def local_moments(self, theta, X, Y):
        g = self.per_sample_grads(theta, X, Y)  # [.., n, p]
        return torch.mean(g, dim=-2), g.transpose(-1, -2) @ g / g.shape[-2]

    def init_theta(self, X, Y):
        theta = X.new_zeros(X.shape[:-2] + X.shape[-1:])
        return self.master_solve(theta, X, Y, torch.zeros_like(theta))

    def master_solve(self, theta, X, Y, linear_term):
        for _ in range(self.master_steps):
            g = self.local_grad(theta, X, Y) - linear_term
            theta = theta - self.lr * g
        return theta


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


def aggregate_gradients(grads, aggregator="vrmom", K: int = 10,
                        scale="master", per_sample_grads_master=None,
                        **agg_kwargs):
    """Aggregate stacked per-machine gradients ``[.., m+1, p]`` (eq. 18/20).

    VRMOM with a non-MAD scale — the paper-faithful ``'master'`` (the
    master's per-sample std, from ``per_sample_grads_master``
    ``[.., n, p]``) or an explicit tensor — runs the plain core
    :func:`core.vrmom.vrmom`, as in ``repro``. Everything else goes
    through the ``Estimator`` (backend ``"auto"`` unless an Estimator is
    given): the worker axis first, the replications and coordinates one
    ``[m+1, R·p]`` stack, which on the card is one launch of B1 (an
    adaptive estimator: a census per replication, then B1 over the
    stack).
    """
    est = Estimator.coerce(aggregator, **agg_kwargs)
    if isinstance(aggregator, str) and est.method == "vrmom":
        est = est._replace(K=K)  # an explicit Estimator keeps its own K
    axis = grads.ndim - 2
    if est.method == "vrmom" and not (isinstance(scale, str)
                                      and scale == "mad"):
        master = (per_sample_grads_master
                  if isinstance(scale, str) and scale == "master" else None)
        return _vrmom(grads, K=est.K, axis=axis, scale=scale,
                      master_samples=master)
    return est.apply(grads, axis=axis)


def rcsl(problem, shards: Shards, generator: Optional[torch.Generator] = None,
         alpha: float = 0.0, attack: str = "none", aggregator="vrmom",
         K: int = 10, scale="master", rounds: int = 10,
         tol: Optional[float] = 1e-4, theta0=None, labelflip: bool = False,
         reduce_backend: str = "direct", consensus=None, fault_plan=None,
         fault_generator: Optional[torch.Generator] = None, **agg_kwargs
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Algorithm 1 on the shards' device. Returns (theta_T [.., p],
    theta trajectory [.., rounds+1, p]).

    ``generator`` feeds the random attacks (it must live on the shards'
    device). ``labelflip=True`` implements the paper's logistic attack
    mode: the Byzantine machines compute *honest* gradients on data whose
    labels were flipped (Y -> 1 - Y) rather than sending arbitrary vectors
    (``attack`` is then not applied). ``tol``: adaptive stopping
    |th_t - th_{t-1}|^2/|th_{t-1}|^2 <= tol, per replication; after it
    triggers, the trajectory repeats the converged iterate and the round
    count stays fixed, as in ``repro``'s scan.

    ``reduce_backend="consensus"`` replaces the master's one-shot
    aggregation (step 3) with the peer-to-peer consensus iteration
    (``dist.consensus``): every machine f-trims and averages what it hears
    until eps-agreement, under an optional ``dist.faults.FaultPlan``, and
    the Byzantine rows re-broadcast their corrupted payload every round.
    The master-scale VRMOM special case does not apply there (the rounds
    run the Estimator, backend ``"torch"``, with its own MAD scale);
    ``consensus`` is a ``dist.consensus.ConsensusConfig`` (by default ``f``
    follows ``alpha``). The rounds' dropout comes from ``fault_generator``
    (one seeded 0 when None), apart from ``generator``, so the attack
    draws are the direct backend's; each replication draws its own.
    """
    if reduce_backend not in ("direct", "consensus"):
        raise ValueError(f"unknown reduce_backend {reduce_backend!r}; "
                         "known: ('direct', 'consensus')")
    X, Y = shards.X, shards.Y
    m1 = X.shape[-3]
    mask = attacks.byzantine_mask(m1, alpha, device=X.device)
    attacks.get(attack)  # an unknown name raises before any compute
    if reduce_backend == "consensus":
        from ..dist.consensus import ConsensusConfig, consensus_aggregate

        est_c = Estimator.coerce(aggregator, backend="torch", **agg_kwargs)
        if isinstance(aggregator, str) and est_c.method == "vrmom":
            est_c = est_c._replace(K=K)
        if consensus is None:
            n_byz = int(alpha * (m1 - 1))
            consensus = ConsensusConfig(f=max(n_byz, 1) if m1 > 5 else 0)
        consensus.validate(m1)
        if fault_generator is None:
            fault_generator = torch.Generator(device=X.device).manual_seed(0)
    X0, Y0 = X[..., 0, :, :], Y[..., 0, :]
    if theta0 is None:
        theta0 = problem.init_theta(X0, Y0)
    theta0 = torch.as_tensor(theta0, dtype=X.dtype, device=X.device
                             ).expand(X.shape[:-3] + X.shape[-1:])
    # label flip: the Byzantine rows' honest gradients on flipped labels
    Y_sent = torch.where(mask[:, None], 1.0 - Y, Y) if labelflip else Y
    est = Estimator.coerce(aggregator, **agg_kwargs)
    master = (est.method == "vrmom" and isinstance(scale, str)
              and scale == "master")

    theta = theta0
    done = torch.zeros(theta.shape[:-1], dtype=torch.bool, device=X.device)
    traj = [theta0]
    for _ in range(rounds):
        grads = problem.local_grad(theta.unsqueeze(-2), X, Y_sent)
        if not labelflip:
            grads = attacks.attack_stack(attack, generator, grads, mask,
                                         axis=grads.ndim - 2)
        if reduce_backend == "consensus":
            gbar, _ = consensus_aggregate(
                grads.float(), est_c, config=consensus, plan=fault_plan,
                generator=fault_generator, pin_mask=mask)
            gbar = gbar.to(grads.dtype)
        else:
            psg = problem.per_sample_grads(theta, X0, Y0) if master else None
            gbar = aggregate_gradients(grads, aggregator=aggregator, K=K,
                                       scale=scale,
                                       per_sample_grads_master=psg,
                                       **agg_kwargs)
        g0 = grads[..., 0, :]
        theta_new = problem.master_solve(theta, X0, Y0, g0 - gbar)
        if tol is not None:
            e = torch.sum((theta_new - theta) ** 2, dim=-1) / torch.clamp_min(
                torch.sum(theta ** 2, dim=-1), 1e-30)
            theta_new = torch.where(done.unsqueeze(-1), theta, theta_new)
            done = done | (e <= tol)
        theta = theta_new
        traj.append(theta)
    return theta, torch.stack(traj, dim=-2)


def make_shards(generator, N_per_machine: int, m_workers: int, p: int,
                theta_star, model: str = "linear", mu_x: float = 0.0,
                toeplitz_rho: float = 0.5, noise_std: float = 1.0,
                reps: Optional[int] = None, device=None) -> Shards:
    """Generate the paper's simulation data (Section 4.2), already sharded:
    ``[m+1, n, p]``, or ``[reps, m+1, n, p]`` for ``reps`` replications.

    Covariates ~ N(mu_x, Sigma) with Toeplitz Sigma_ij = rho^|i-j|.
    ``generator``: a ``torch.Generator`` on ``device`` or an int seed.
    ``device=None`` is the card (it raises where there is none).
    """
    dev = resolve_device(device)
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(generator)))
    m1 = m_workers + 1
    lead = () if reps is None else (reps,)
    idx = np.arange(p)
    Sigma = toeplitz_rho ** np.abs(idx[:, None] - idx[None, :])
    L = torch.from_numpy(np.linalg.cholesky(Sigma).astype(np.float32)).to(dev)
    X = torch.randn(lead + (m1, N_per_machine, p), generator=gen, device=dev)
    X = X @ L.T
    X += mu_x
    eta = _mv(X, torch.as_tensor(theta_star, dtype=torch.float32).to(dev))
    if model == "linear":
        Y = eta + noise_std * torch.randn(eta.shape, generator=gen, device=dev)
    elif model == "logistic":
        U = torch.rand(eta.shape, generator=gen, device=dev)
        Y = (U < torch.sigmoid(eta)).float()
    else:
        raise ValueError(model)
    return Shards(X=X, Y=Y)


def paper_theta_star(p: int, device=None) -> torch.Tensor:
    """theta* = p^{-1/2} (1, (p-2)/(p-1), (p-3)/(p-1), ..., 0) (Section 4).
    ``device=None`` is the card."""
    dev = resolve_device(device)
    if p == 1:
        return torch.ones(1, device=dev)
    ks = torch.arange(p, device=dev)
    vals = torch.cat([torch.ones(1, device=dev), (p - 1 - ks[1:]) / (p - 1)])
    return vals / torch.sqrt(torch.tensor(float(p), device=dev))
