"""Byzantine-robust gradient reduction over emulated workers
(``repro.dist.robust_reduce``'s one-card half).

The semantics are ``repro``'s: coordinate-wise robust aggregation (VRMOM
eq. 7 / MOM / trimmed mean / mean) of per-worker gradients stacked on a
leading worker dim, with the estimator given by one
``core.estimator.Estimator`` spec. On one card the W workers are
emulated, so there is no wire:

* ``aggregate_stacked_auto`` — the estimator on each leaf's ``[W, numel]``
  stack (``repro``'s jit-native path). A stack in bf16 goes to the kernel
  (B1) as it is: B1 reads bf16, computes in f32 and writes bf16, which is
  bitwise ``repro``'s cast to f32, aggregate, cast back, without an f32
  copy of the stack (at full width that copy would not fit beside it).
* ``aggregate`` — the mode dispatcher of the train step: ``stacked-auto``
  (``auto``), ``stacked-rrs`` and ``mean``. ``repro``'s Robust-Reduce-
  Scatter wire (one all-to-all and one all-gather over the worker axes)
  runs ``stacked-auto`` at one worker rank, which is what one card is; the
  wire itself comes with multi-card training (ROADMAP.md, A5).
* ``robust_backward`` + ``robust_dot`` — in-backward aggregation
  (``repro``'s IB-RRS): a matmul whose weight gradient is the robust
  aggregate of the per-worker partial ``dW``, computed inside the
  backward, so no stacked gradient of the whole model exists.
* ``aggregate_symmetric_stacked`` — the inference layer's stacks of
  symmetric matrices.

Adaptive estimators and the consensus backend raise, naming ROADMAP.md's
A6.
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

from ..core.estimator import Estimator
from ..tree import tree_map
from . import ctx as CTX

__all__ = ["aggregate", "aggregate_stacked_auto", "aggregate_symmetric_stacked",
           "robust_backward", "robust_dot", "robust_dot_enabled"]

EstimatorLike = Union[str, Estimator]


def _wire_estimator(est: EstimatorLike) -> Estimator:
    """Coerce, and refuse what one-card aggregation cannot run: adaptive
    estimators (their census needs the full wire, A6) and whole-vector
    ones (coordinate-wise aggregation only)."""
    est = Estimator.coerce(est)
    if est.adaptive:
        raise NotImplementedError(
            f"adaptive estimator {est.method!r} is not ported yet (the "
            f"adaptive tier: ROADMAP.md, A6)")
    return est.require_coordinatewise(
        "stacked aggregation (dist.robust_reduce)")


def _with_tree_diag(grads, out):
    """``(out, obs.diag.tree_diagnose(grads, out))``: the per-worker
    deviation diagnostics of a stacked tree against its aggregate, the
    same for every mode."""
    from ..obs import diag as OD
    from ..obs.trace import named_span

    with named_span("obs.tree_diagnose"):
        return out, OD.tree_diagnose(grads, out)


def _aggregate_leaf(est: Estimator, g):
    """One ``[W, ...]`` leaf -> ``[...]`` in its dtype. The kernel backend
    takes the stack in its own dtype (f32 math inside); the others get
    ``repro``'s f32 cast."""
    flat = g.reshape(g.shape[0], -1)
    if est.resolve_backend() == "cuda":
        out = est.apply(flat, axis=0)
    else:
        out = est.apply(flat.float(), axis=0).to(g.dtype)
    return out.reshape(g.shape[1:])


def aggregate_stacked_auto(grads, est: EstimatorLike = "vrmom", *,
                           with_diag: bool = False,
                           reduce_backend: str = "direct"):
    """The estimator on every leaf of a stacked tree (leaves ``[W, ...]``,
    or one such tensor); returns the aggregate without the worker dim,
    and with ``with_diag`` the pair ``(aggregate,
    obs.diag.AggDiagnostics)``. ``reduce_backend="consensus"`` (peer-to-
    peer approximate consensus) is not ported (A6)."""
    if reduce_backend == "consensus":
        raise NotImplementedError(
            "reduce_backend='consensus' is not ported yet (the consensus "
            "backend: ROADMAP.md, A6)")
    if reduce_backend != "direct":
        raise ValueError(f"unknown reduce_backend {reduce_backend!r}; "
                         "known: ('direct', 'consensus')")
    est = _wire_estimator(est)
    out = tree_map(lambda g: _aggregate_leaf(est, g), grads)
    if with_diag:
        return _with_tree_diag(grads, out)
    return out


def aggregate(grads, *, mode: str = "stacked-rrs",
              est: EstimatorLike = "vrmom", with_diag: bool = False):
    """Mode dispatcher of ``train/step.py``: ``stacked-rrs`` and
    ``stacked-auto`` (``auto``) run ``aggregate_stacked_auto`` (one card
    is one worker rank of ``repro``'s RRS wire, where ``repro`` itself
    takes the same path); ``mean`` is the plain mean over the workers, the
    non-robust baseline, accumulated in f32 without an f32 copy of the
    stack. ``with_diag`` returns ``(aggregate, AggDiagnostics)`` for every
    mode."""
    if mode == "stacked-consensus":
        raise NotImplementedError(
            "mode 'stacked-consensus' is not ported yet (the consensus "
            "backend: ROADMAP.md, A6)")
    if mode in ("stacked-rrs", "stacked-auto", "auto"):
        return aggregate_stacked_auto(grads, est, with_diag=with_diag)
    if mode == "mean":
        out = tree_map(lambda g: torch.mean(g, dim=0, dtype=torch.float32
                                            ).to(g.dtype), grads)
        if with_diag:
            return _with_tree_diag(grads, out)
        return out
    raise ValueError(f"unknown aggregation mode {mode!r}")


def aggregate_symmetric_stacked(mats, est: EstimatorLike = "vrmom"):
    """Robustly aggregate a stack of symmetric matrices ``[.., W, p, p]``
    over its worker axis W (leading axes are replications).

    Used by the inference layer for the per-machine Hessian and
    gradient-second-moment stacks. Only the ``p(p+1)/2`` upper-triangle
    coordinates are aggregated, as one ``[W, R·p(p+1)/2]`` stack through
    the Estimator, and the aggregated triangle is mirrored back, so the
    output is *exactly* symmetric (which downstream solves deserve).
    """
    est = Estimator.coerce(est).require_stackable(
        "symmetric-stack aggregation (dist.robust_reduce)")
    if mats.ndim < 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"expected [.., W, p, p] symmetric stack, got "
                         f"{tuple(mats.shape)}")
    p = mats.shape[-1]
    iu = torch.triu_indices(p, p, device=mats.device)
    tri = mats[..., iu[0], iu[1]].float()          # [.., W, p(p+1)/2]
    agg = est.apply(tri, axis=tri.ndim - 2)        # [.., p(p+1)/2]
    out = torch.zeros(agg.shape[:-1] + (p, p), dtype=torch.float32,
                      device=mats.device)
    out[..., iu[0], iu[1]] = agg
    out = out + torch.triu(out, 1).transpose(-1, -2)
    return out.to(mats.dtype)


# ---------------------------------------------------------------------------
# In-backward aggregation: robust_dot under a robust_backward context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def robust_backward(n_workers: int, est: EstimatorLike = "vrmom"):
    """While active, the layers' ``_dot`` routes 3-D x 2-D products
    through ``robust_dot``, so each weight gradient is aggregated over the
    ``n_workers`` workers (the batch split into equal worker-major
    blocks) inside the backward."""
    CTX.push_robust_backward(
        CTX.RobustBackwardState(int(n_workers), _wire_estimator(est)))
    try:
        yield
    finally:
        CTX.pop_robust_backward()


def robust_dot_enabled() -> bool:
    return CTX.robust_backward_state() is not None


class _RobustDot(torch.autograd.Function):
    """``x @ w`` (x [B, S, D], w [D, F]) whose backward returns ``dx = dy
    @ wᵀ`` and, for ``dw``, the Estimator's aggregate of the per-worker
    partial products ``einsum("wbsd,wbsf->wdf")`` in f32 (B1 on the
    card), cast to w's dtype. As in ``repro``, each worker's ``dW`` is its
    share of the gradient of the global loss, so with the mean the result
    is the global ``dW / W`` (ROADMAP.md §C)."""

    @staticmethod
    def forward(ctx, x, w, n_workers: int, est: Estimator):
        ctx.save_for_backward(x, w)
        ctx.n_workers, ctx.est = n_workers, est
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nw, B = ctx.n_workers, x.shape[0]
        dx = (dy @ w.t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        if nw > 1 and B % nw:
            raise ValueError(
                f"robust_dot: batch dim {B} is not divisible by the {nw} "
                f"workers; dW cannot be grouped per worker")
        D, F = w.shape
        if nw <= 1:
            dw = x.reshape(-1, D).float().t() @ dy.reshape(-1, F).float()
            return dx, dw.to(w.dtype), None, None
        xw = x.reshape(nw, -1, D).float()
        dyw = dy.reshape(nw, -1, F).float()
        dws = torch.bmm(xw.transpose(1, 2), dyw)  # [W, D, F] f32
        del xw, dyw
        dw = aggregate_stacked_auto(dws, ctx.est)
        return dx, dw.to(w.dtype), None, None


def robust_dot(x, w):
    """``x @ w`` (x [B, S, D], w [D, F]) whose ``dW`` is the robust
    aggregate of per-worker ``dW`` under an active ``robust_backward``
    context (plain ``x @ w`` without one). The worker count must divide
    B."""
    state = CTX.robust_backward_state()
    if state is None:
        return x @ w
    return _RobustDot.apply(x, w, state.n_workers, state.estimator)
