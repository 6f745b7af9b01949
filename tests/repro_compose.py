"""``repro``'s training step composed without a mesh, for the port's train
tests to hold ``repro_torch.train.step`` against.

``repro``'s ``make_train_step`` needs a mesh of several devices, so the
tests compose ``repro``'s own pieces: ``jax.vmap`` of
``jax.value_and_grad(model.loss)`` over ``W`` workers, the attack of
``repro.core.attacks``, ``robust_reduce.aggregate_stacked_auto`` and
``repro.optim``'s update; the inloop wire is ``repro``'s
``_robust_dot_bwd`` with that mesh-free aggregate in place of the mesh's.
Also the two conversions every such test makes: ``repro``'s params into
the port's, and a ``repro`` tree against a port tree.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import attacks as JA
from repro.core.estimator import Estimator as JEstimator
from repro.dist import ctx as JCTX
from repro.dist import robust_reduce as JRR
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.tree import leaves


def tparams(jp, tcfg):
    """``repro``'s params ``jp`` as the port's, on the CPU."""
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def close_tree(jtree, ttree, tol):
    """Every leaf of the port's ``ttree`` equals ``repro``'s ``jtree``'s at
    ``tol`` (rtol and atol), in f32."""
    jl, tl = jax.tree.leaves(jtree), list(leaves(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b.detach().float()),
                                   np.asarray(a, np.float32),
                                   rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def worker_grads(jcfg):
    vg = jax.value_and_grad(lambda p, b: JM.loss(p, jcfg, b))
    return jax.jit(jax.vmap(vg, in_axes=(None, 0)))


def stack(jcfg, jp, jb, W):
    """(each worker's loss, each leaf's ``[W, ...]`` gradient stack): the
    batch ``jb`` cut into ``W`` consecutive slices."""
    bw = jax.tree.map(lambda x: x.reshape((W, -1) + x.shape[1:]), jb)
    return worker_grads(jcfg)(jp, bw)


def step(jcfg, jp, jo, jb, est, attack, n_byz, opt, mode, W):
    """One step: the stack, ``attack`` on its last ``n_byz`` rows, the
    plain mean (``mode`` "mean") or ``aggregate_stacked_auto`` with
    ``est``, and ``opt``'s update -> (params, opt state, mean loss)."""
    losses, g = stack(jcfg, jp, jb, W)
    if n_byz:
        mask = jnp.arange(W) >= (W - n_byz)
        g = jax.tree.map(
            lambda x: JA.get(attack)(jax.random.PRNGKey(0), x, mask), g)
    if mode == "mean":
        agg = jax.tree.map(lambda x: jnp.mean(x.astype(jnp.float32), axis=0
                                              ).astype(x.dtype), g)
    else:
        agg = JRR.aggregate_stacked_auto(g, est)
    jp, jo = opt.update(agg, jo, jp)
    return jp, jo, jnp.mean(losses)


def inloop_dot(est, W):
    """``repro``'s ``_robust_dot`` (``dist/robust_reduce.py:378-409``)
    with ``aggregate_stacked_auto`` in place of the mesh's aggregate."""

    @jax.custom_vjp
    def dot(x, w):
        return jnp.einsum("bsd,df->bsf", x, w)

    def fwd(x, w):
        return dot(x, w), (x, w)

    def bwd(res, dy):
        x, w = res
        dx = jnp.einsum("bsf,df->bsd", dy, w).astype(x.dtype)
        B = x.shape[0]
        xw = x.reshape((W, B // W) + x.shape[1:])
        dyw = dy.reshape((W, B // W) + dy.shape[1:])
        dws = jnp.einsum("wbsd,wbsf->wdf", xw.astype(jnp.float32),
                         dyw.astype(jnp.float32))
        return dx, JRR.aggregate_stacked_auto(dws, est).astype(w.dtype)

    dot.defvjp(fwd, bwd)
    return dot


def grads(monkeypatch, jcfg, jp, jb, W, method=None):
    """``repro``'s loss gradients, on its inloop wire over ``W`` workers
    when ``method``."""
    loss = jax.value_and_grad(lambda p: JM.loss(p, jcfg, jb))
    if method is None:
        return loss(jp)[1]
    monkeypatch.setattr(JRR, "robust_dot", inloop_dot(
        JEstimator(method, backend="ref"), W))
    JCTX.push_robust_backward(JCTX.RobustBackwardState(None, ("data",),
                                                       method))
    try:
        return loss(jp)[1]
    finally:
        JCTX.pop_robust_backward()
