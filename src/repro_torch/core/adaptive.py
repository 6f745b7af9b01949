"""The adaptive aggregation tier: estimators that estimate alpha instead of
assuming it (the port of ``repro.core.adaptive``, DESIGN.md §14).

The fixed estimators are calibrated for a *known* contamination fraction;
the omniscient attacks (``core.attacks``: alie / ipm / mimic) land their
payloads inside the honest spread, where the MAD-z suspicion census of
``obs.diag`` is blind and a fixed-K VRMOM keeps its honest-regime
trade-off while the contamination drags it. This module adds the online
layer:

* ``census`` — a per-stack worker census of two signals: the robust
  z-score of each row's L2 deviation from the coordinatewise median
  (exact against loud attacks), and the multiplicity of duplicate rows
  (exact against coordinated attacks, whose Byzantine rows are copies of
  one payload while honest continuous rows never collide). Duplicate
  clusters holding more than half the stack are the honest consensus
  (serve replicas are bit-identical) and stay exempt.
* ``estimate_alpha`` — the censused contamination ``alpha_hat`` in
  ``[0, 0.5)``; exactly ``0.0`` on honest stacks.
* ``auto_gm`` — Weiszfeld's geometric median under the census trust
  weights; honest stacks weigh every row 1.0, so it is bit-identical to
  ``aggregators.geometric_median``.
* ``vrmom_adaptive`` — imputes censused rows at the coordinatewise median,
  runs VRMOM at every rung of a static K ladder and picks the rung by
  ``alpha_hat`` with ``torch.where`` on the device (no host read, so a
  CUDA graph can capture it). ``alpha_hat == 0`` picks the configured K
  on the unmodified stack: bit-identical to fixed-K ``vrmom``.
* ``AdaptiveState`` / ``apply_adaptive`` — EMA per-worker weights, EMA
  ``alpha_hat`` and aggregate momentum, threaded by the caller as an
  explicit carry.

Stacks are ``[b..., m, c...]`` with the worker axis at ``axis``: the dims
before it are independent batches (one census each: the coverage
harness's replications), the dims after it a row's coordinates.
``apply_adaptive`` follows ``repro``: the worker axis first and every
other dim a coordinate, one census, one state.

``backend``: ``"torch"`` runs the plain ``core.vrmom.vrmom`` rungs and
``aggregators.median`` centre; ``"auto"`` and ``"cuda"`` run each rung
and the centre as one launch of B1 (``kernels.vrmom.aggregate``) over
``[m, B·C]``, which on a CPU tensor is B1's plain version and on a CUDA
tensor the kernel (it raises rather than fall back).

Only the f32 summation order differs from ``repro``: the distances and
``z`` agree to ~1e-7 relative, the masks, counts and weights exactly on
stacks away from the thresholds. ``alpha_hat`` is the suspected count
times f32(1/W), the reciprocal multiply XLA makes of ``repro``'s mean.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import aggregators as _A
from .vrmom import mad_scale, mom, vrmom as _vrmom_plain

__all__ = ["StackCensus", "AdaptiveState", "census", "census_from_distances",
           "estimate_alpha", "worker_weights", "auto_gm", "vrmom_adaptive",
           "select_k", "k_ladder", "ladder_select", "init_state", "ema",
           "momentum_update", "apply_adaptive", "Z_THRESH", "REL_FLOOR",
           "SUSPECT_WEIGHT", "LOUD_RATIO", "K_LADDER_THRESHOLDS",
           "DUP_REL_TOL", "census_of_blocks"]

# The suspicion convention of obs.diag: the same robust z-score, threshold
# and relative floor (tests hold the two equal).
Z_THRESH = 4.0
REL_FLOOR = 0.05

# Residual trust weight of a row the z-census flags as a loud outlier.
SUSPECT_WEIGHT = 1e-3

# A loud row must also deviate by this multiple of the typical deviation:
# honest rows sit at dev / mom(dev) = 1 + O(1/sqrt(C)), so an honest stack
# never reaches it, even where the MAD-z alone has a false positive. This
# is what makes the honest bit identity hold on every stack.
LOUD_RATIO = 1.5

# alpha_hat cutoffs of the static K ladder: at or below the first the
# configured K, at or below the second K//2, above it K = 1. Compared in
# f32, so an alpha_hat of f32(0.2) (W = 5 or 10) takes the K//2 rung.
K_LADDER_THRESHOLDS = (0.02, 0.2)

# Relative pairwise-distance threshold of the duplicate census: rows of one
# coordinated payload are identical (distance exactly 0.0); honest rows
# sit at the stack's typical pairwise scale.
DUP_REL_TOL = 1e-10


class StackCensus(NamedTuple):
    """Worker census of a stack (W rows; a leading batch dim when the
    stack has one)."""

    z: torch.Tensor             # [W] f32 — robust z-score of row deviation
    cluster_size: torch.Tensor  # [W] i32 — duplicate-cluster multiplicity
    suspected: torch.Tensor     # [W] bool — z-outlier or minority duplicate
    alpha_hat: torch.Tensor     # []  f32 — censused contamination fraction
    weights: torch.Tensor       # [W] f32 — instantaneous trust weights
    center: Optional[torch.Tensor]  # [C] f32 coordinatewise median (None
    # where the caller walks the stack in chunks and keeps no whole centre)


class AdaptiveState(NamedTuple):
    """The momentum-smoothed aggregation carry, threaded by the caller."""

    weights: torch.Tensor    # [W] f32 — EMA per-worker trust weights
    momentum: torch.Tensor   # [C] f32 — EMA of the flat aggregate
    step: torch.Tensor       # []  i32 — update count
    alpha_hat: torch.Tensor  # []  f32 — EMA contamination estimate


def _kernel(backend: str) -> bool:
    """Whether ``backend`` runs the centre and the rungs on B1."""
    if backend not in ("torch", "auto", "cuda"):
        raise ValueError(f"adaptive tier: backend {backend!r} runs no "
                         f"adaptive method (torch, auto, cuda)")
    return backend != "torch"


def _coordinatewise(flat, method: str, K: int, kernel: bool):
    """median or vrmom over the rows of ``[B, W, C]`` -> ``[B, C]`` f32:
    one B1 launch over ``[W, B·C]``, or the plain PyTorch estimator."""
    if not kernel:
        if method == "median":
            return _A.median(flat, axis=1)
        return _vrmom_plain(flat, K=K, axis=1)
    from ..kernels.vrmom import aggregate

    B, W, C = flat.shape
    x = flat[0] if B == 1 else flat.transpose(0, 1).reshape(W, B * C)
    return aggregate(x.contiguous(), method=method, K=K).reshape(B, C)


def census_from_distances(dev, d2, center=None) -> StackCensus:
    """The census from each row's L2 deviation from the centre ``dev``
    ``[B, W]`` and the rows' squared distances ``d2`` ``[B, W, W]``, both
    f32 (the chunked training wire accumulates them column block by
    column block). The median of ``d2`` runs over all W² entries, the
    zero diagonal included, as in ``repro``."""
    B, W = dev.shape
    c_dev = mom(dev, axis=1)
    scale = mad_scale(dev, axis=1, center=c_dev)
    z = (dev - c_dev[:, None]) / (scale[:, None] + REL_FLOOR * c_dev[:, None]
                                  + 1e-12)
    z_sus = (z > Z_THRESH) & (dev > LOUD_RATIO * c_dev[:, None])
    med_d2 = _A.median(d2.reshape(B, W * W), axis=1)
    dup = d2 <= (DUP_REL_TOL * med_d2[:, None, None] + 1e-30)
    csize = torch.sum(dup, dim=2, dtype=torch.int32)
    dup_sus = (csize > 1) & (csize <= W // 2)
    suspected = z_sus | dup_sus
    inv_w = torch.full((), float(np.float32(1) / np.float32(W)),
                       dtype=torch.float32, device=dev.device)
    alpha_hat = torch.clamp(
        torch.sum(suspected, dim=1, dtype=torch.float32) * inv_w, 0.0, 0.499)
    ones = torch.ones_like(dev)
    w = torch.where(dup_sus, torch.reciprocal(csize.float()), ones)
    weights = torch.where(z_sus, w * SUSPECT_WEIGHT, w)
    return StackCensus(z=z, cluster_size=csize, suspected=suspected,
                       alpha_hat=alpha_hat, weights=weights, center=center)


def _census(flat, kernel: bool) -> StackCensus:
    """Batched census of ``[B, W, C]`` f32 rows (fields with a leading B)."""
    center = _coordinatewise(flat, "median", 0, kernel)
    dev = torch.sqrt(torch.sum(torch.square(flat - center[:, None]), dim=-1))
    return census_from_distances(dev, _A.pairwise_sq(flat), center)


def census_of_blocks(blocks, kernel: bool) -> StackCensus:
    """The census of a ``[W, C]`` stack handed in as ``[W, c]`` column
    blocks (the chunked training wire), accumulated block by block: each
    row's squared deviation from the block's coordinatewise median and the
    rows' squared distances (direct differences) in f32. No centre is
    kept (``center=None``)."""
    dev2 = d2 = None
    for block in blocks:
        f = block.float().contiguous()[None]
        if dev2 is None:
            W, dev = f.shape[1], f.device
            dev2 = torch.zeros((1, W), dtype=torch.float32, device=dev)
            d2 = torch.zeros((1, W, W), dtype=torch.float32, device=dev)
        center = _coordinatewise(f, "median", 0, kernel)
        dev2 += torch.sum(torch.square(f - center[:, None]), dim=-1)
        d2 += _A.pairwise_sq(f)
    return _squeeze(census_from_distances(torch.sqrt(dev2), d2))


def _squeeze(cen: StackCensus) -> StackCensus:
    return StackCensus(*(None if f is None else f[0] for f in cen))


def census(flat, backend: str = "torch") -> StackCensus:
    """Worker census of a flat ``[W, C]`` stack (f32 math).

    Signal 1 (loud attacks): the robust z-score of each row's L2 deviation
    from the coordinatewise median. Signal 2 (coordinated attacks):
    duplicate multiplicity — squared distances at most ``DUP_REL_TOL``
    times the stack's median squared distance, found by direct
    differences, mark rows sharing one payload; clusters of more than half
    the stack are the honest consensus and stay exempt. Honest continuous
    stacks trip neither: ``suspected`` all false, ``alpha_hat`` exactly
    0.0."""
    return _squeeze(_census(flat[None].float(), _kernel(backend)))


def estimate_alpha(x, axis: int = 0, backend: str = "torch"):
    """The censused fraction of suspected rows, in ``[0, 0.5)``, one per
    batch (``[b...]``); exactly 0.0 on honest stacks."""
    flat, batch, _ = _A.rows(x, axis)
    return _census(flat, _kernel(backend)).alpha_hat.reshape(batch)


def worker_weights(x, axis: int = 0, backend: str = "torch"):
    """``[b..., W]`` instantaneous trust weights (all exactly 1.0 on honest
    stacks): a minority duplicate cluster shares one vote
    (``1/cluster_size``), a loud z-outlier keeps ``SUSPECT_WEIGHT``."""
    flat, batch, _ = _A.rows(x, axis)
    w = _census(flat, _kernel(backend)).weights
    return w.reshape(batch + w.shape[-1:])


def auto_gm(x, axis: int = 0, iters: int = 8, eps: float = 1e-8,
            weights=None, backend: str = "torch"):
    """Auto-weighted geometric median: Weiszfeld under the census trust
    weights (or the caller's ``weights`` [W], e.g. an EMA state). Honest
    stacks weigh every row 1.0: bit-identical to
    ``aggregators.geometric_median``."""
    flat, batch, rest = _A.rows(x, axis)
    if weights is None:
        pi = _census(flat, _kernel(backend)).weights
    else:
        pi = weights.expand(flat.shape[:2])
    y = _A.weiszfeld(flat, pi, iters=iters, eps=eps)
    return y.reshape(batch + rest).to(x.dtype)


def k_ladder(K: int) -> Tuple[int, ...]:
    """Static K candidates, largest first: the configured K for the honest
    regime, K//2 for moderate contamination, 1 for heavy (VRMOM's
    correction bound grows with K, so the ladder trades variance reduction
    for contamination bias as ``alpha_hat`` rises). Deduplicated, order
    kept."""
    out = []
    for k in (int(K), max(int(K) // 2, 1), 1):
        if k not in out:
            out.append(k)
    return tuple(out)


def ladder_select(alpha_hat, candidates):
    """Branchless ladder select on the device: ``candidates[i]`` where
    ``alpha_hat`` (``[B]`` or 0-d f32) is at most the i-th f32 threshold,
    the last candidate above them all. Candidates broadcast against
    ``alpha_hat`` with trailing dims."""
    out = candidates[-1]
    extra = out.ndim - alpha_hat.ndim
    a = alpha_hat.reshape(alpha_hat.shape + (1,) * extra)
    for thr, cand in zip(
            reversed(K_LADDER_THRESHOLDS[:len(candidates) - 1]),
            reversed(candidates[:-1])):
        t = torch.full((), thr, dtype=torch.float32, device=a.device)
        out = torch.where(a <= t, cand, out)
    return out


def select_k(alpha_hat, K: int):
    """The ladder rung (f32, the shape of ``alpha_hat``) that
    ``vrmom_adaptive`` runs at for this ``alpha_hat``."""
    return ladder_select(alpha_hat, [
        torch.full(alpha_hat.shape, float(k), dtype=torch.float32,
                   device=alpha_hat.device) for k in k_ladder(K)])


def _impute_and_climb(flat, suspected, center, alpha_hat, K: int,
                      kernel: bool):
    """Suspected rows set to the centre, VRMOM at every rung, the rung
    ``alpha_hat`` selects: ``[B, W, C]`` -> ``[B, C]`` f32."""
    x_adj = torch.where(suspected[..., None], center[:, None, :], flat)
    outs = [_coordinatewise(x_adj, "vrmom", k, kernel) for k in k_ladder(K)]
    return ladder_select(alpha_hat, outs)


def vrmom_adaptive(x, K: int = 10, axis: int = 0, backend: str = "torch"):
    """Adaptive-K VRMOM: census each stack, impute its suspected rows at
    the coordinatewise median, run VRMOM at every ladder rung (one B1
    launch a rung on the kernel backends) and select the rung by
    ``alpha_hat``. ``alpha_hat == 0`` imputes nothing and selects the
    configured K: bit-identical to fixed-K ``vrmom`` on the same
    backend."""
    flat, batch, rest = _A.rows(x, axis)
    kernel = _kernel(backend)
    cen = _census(flat, kernel)
    y = _impute_and_climb(flat, cen.suspected, cen.center, cen.alpha_hat, K,
                          kernel)
    return y.reshape(batch + rest).to(x.dtype)


def init_state(n_workers: int, dim: int, device=None) -> AdaptiveState:
    """Honest-prior carry: unit trust, zero momentum, step 0, on ``device``
    (the card unless the caller names another; with no card it raises)."""
    dev = resolve_device(device)
    return AdaptiveState(
        weights=torch.ones((n_workers,), dtype=torch.float32, device=dev),
        momentum=torch.zeros((dim,), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        alpha_hat=torch.zeros((), dtype=torch.float32, device=dev),
    )


def ema(state: AdaptiveState, cen: StackCensus, weights_beta: float):
    """(w_ema, a_ema): ``(1 - beta) * old + beta * new`` in f32 for the
    weights and ``alpha_hat``; unit weights are a fixed point."""
    beta = torch.full((), weights_beta, dtype=torch.float32,
                      device=state.weights.device)
    w_ema = (1.0 - beta) * state.weights + beta * cen.weights
    a_ema = (1.0 - beta) * state.alpha_hat + beta * cen.alpha_hat
    return w_ema, a_ema


def momentum_update(old, agg, momentum: float, step):
    """``(out, m_new)`` for a flat f32 aggregate, or a column block of it
    with ``old`` (the state's momentum) cut to match: ``m_new = mu * old +
    (1 - mu) * agg``; ``out`` is ``agg`` itself at ``momentum == 0`` and
    the bias-corrected ``m_new / (1 - mu^step)`` otherwise, ``step`` the
    new update count (0-d int32)."""
    mu = torch.full((), momentum, dtype=torch.float32, device=agg.device)
    m_new = mu * old + (1.0 - mu) * agg
    if not momentum:
        return agg, m_new
    return m_new / (1.0 - mu ** step.float()), m_new


def apply_adaptive(method: str, x, state: AdaptiveState, axis: int = 0, *,
                   K: int = 10, weights_beta: float = 0.5,
                   momentum: float = 0.0, backend: str = "torch"
                   ) -> Tuple[torch.Tensor, AdaptiveState]:
    """One stateful adaptive aggregate: ``(aggregate, new_state)``.

    Census the stack (worker axis ``axis``, every other dim a coordinate,
    as in ``repro``), EMA the per-worker trust weights and ``alpha_hat``
    with ``weights_beta``, aggregate under the smoothed weights
    (``auto_gm``: Weiszfeld; ``vrmom_adaptive``: rows with an EMA weight
    below 0.5 imputed, the rung the EMA ``alpha_hat`` selects), and
    momentum-smooth the flat aggregate (bias-corrected only when
    ``momentum != 0``; at 0.0 the instantaneous aggregate exactly). The
    state is an explicit carry; honest stacks keep it at the unit fixed
    point and match the stateless ``apply`` bit for bit."""
    if method not in ("auto_gm", "vrmom_adaptive"):
        raise ValueError(f"not an adaptive method: {method!r}")
    kernel = _kernel(backend)
    xm = torch.movedim(x, axis, 0)
    flat = xm.reshape(1, xm.shape[0], -1).float()
    cen = _census(flat, kernel)
    w_ema, a_ema = ema(state, _squeeze(cen), weights_beta)
    if method == "auto_gm":
        agg = _A.weiszfeld(flat, w_ema[None])[0]
    else:
        agg = _impute_and_climb(flat, (w_ema < 0.5)[None], cen.center,
                                a_ema, K, kernel)[0]
    step = state.step + 1
    out, m_new = momentum_update(state.momentum, agg, momentum, step)
    new_state = AdaptiveState(weights=w_ema, momentum=m_new, step=step,
                              alpha_hat=a_ema)
    return out.reshape(xm.shape[1:]).to(x.dtype), new_state
