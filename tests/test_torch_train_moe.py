"""repro_torch training of the moe family (granite) against ``repro``.

Both packages run granite-moe-3b-a800m at its ``reduced()`` size (2
layers, 4 heads of 32 over 2 kv heads, vocab 512, f32) with granite's own
routing, 40 experts top-8 at capacity factor 1.25, and d_model 64, at
``repro``'s seeded params (``convert.params_from_jax``), on
``lm_batch``'s tokens. A 24-token row is one routing group of capacity
int(1.25 * 8 * 24 / 40) = 6 rows an expert, and the seeded router drops
slots there. As in ``test_torch_train.py``, ``repro``'s ``make_train_step``
needs a mesh of several devices, so the port's step is held against the
mesh-free composition of ``repro``'s own pieces (``repro_compose``):
``jax.vmap`` of ``jax.value_and_grad(model.loss)`` over the workers, the
attack of ``repro.core.attacks``, ``robust_reduce.aggregate_stacked_auto``
and ``repro.optim``'s update, the Estimator on its ``ref`` oracle; its
inloop wire is ``repro``'s ``_robust_dot_bwd`` with that mesh-free
aggregate in place of the mesh's.

Tolerances: the loss at 1e-5, three train steps' params and momentum at
2e-5 (SGD with momentum, as in ``test_torch_train.py``: AdamW turns float
noise in a near-zero gradient into a step of ~lr) with the trimmed mean,
the median and the mean; VRMOM, whose count of z <= Delta_k jumps on
1e-7 input differences, on ``repro``'s own stack at 1e-5, and through
three steps fed ``repro``'s stacks at 2e-5 (the loss to 1e-6); the loss and
gradients at 1e-4 against ``repro`` (``test_torch_moe``'s f32
tolerance), remat on against remat off at 1e-6 (the same arithmetic
recomputed); a worker's row of the stack bitwise its own gradients; the
inloop gradients at 1e-4 against ``repro``'s wire, the router's and the
experts' gradients under the wire bitwise the plain batch gradient in the
port and at 1e-6 in ``repro``; a planted misrouted recompute leaves the
loss bitwise and moves each moe leaf's gradient by more than 1e-2 of its
largest entry.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import MoEConfig as JMoE
from repro.configs import get as j_get_arch
from repro.core import attacks as JA
from repro.core.estimator import Estimator as JEstimator
from repro.data import lm_batch as j_lm_batch
from repro.dist import robust_reduce as JRR
from repro.models import model as JM
from repro.models import moe as JX
from repro_torch import optim as TO
from repro_torch.configs import MoEConfig as TMoE
from repro_torch.configs import get as t_get_arch
from repro_torch.core.estimator import Estimator
from repro_torch.data import lm_batch
from repro_torch.dist import robust_reduce as RR
from repro_torch.models import moe as TX
from repro_torch.train import step as TS
from repro_torch.train.step import (loss_and_grads, make_train_step,
                                    stacked_grads)
from repro_torch.tree import at, leaves as _leaves, paths

import repro_compose as RC
from repro_compose import close_tree, tparams

torch.set_num_threads(1)

NAME = "granite-moe-3b-a800m"
REPO = Path(__file__).resolve().parent.parent
W = 4
BATCH, SEQ = 8, 24
MOE = (40, 8, 1.25)   # granite's experts, top-k and capacity factor
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")
ATTN_LEAVES = ("wq", "wk", "wv", "wo")


def _cfgs(**kw):
    jc = dataclasses.replace(j_get_arch(NAME).reduced(), d_model=64,
                             moe=JMoE(*MOE), **kw)
    tc = dataclasses.replace(t_get_arch(NAME).reduced(), d_model=64,
                             moe=TMoE(*MOE), **kw)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, JM.init(jax.random.PRNGKey(0), jcfg)


def _tbatch(cfg, step, batch=BATCH, seq=SEQ):
    return lm_batch(cfg, step, batch, seq, device="cpu")


def _routings(fn):
    """``fn()`` with the port's ``moe.route`` wrapped -> (fn's result,
    every Routing it made, in call order)."""
    real, calls = TX.route, []

    def keep(x, router, cfg):
        r = real(x, router, cfg)
        calls.append(r)
        return r

    TX.route = keep
    try:
        return fn(), calls
    finally:
        TX.route = real


# ---------------------------------------------------------------------------
# the stacked step against repro's mesh-free composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,method,attack,byz", [
    ("stacked-auto", "trimmed_mean", "none", 0.0),
    ("stacked-auto", "median", "signflip", 0.4),
    ("mean", "mean", "signflip", 0.4),
])
def test_three_stacked_steps_match_repro(mode, method, attack, byz):
    """Three steps of the port's ``make_train_step`` (every worker's rows
    routed in their own groups, slots dropped at capacity) against
    ``repro``'s stack, attack, aggregate and SGD update: the loss each
    step, then the params and the momentum."""
    jcfg, tcfg, jp = _models()
    jopt = JO.get("sgd", lr=0.5, momentum=0.9)
    topt = TO.get("sgd", lr=0.5, momentum=0.9)
    jo = jopt.init(jp)
    beta = 0.25  # trims one of 4 rows a side
    setup = make_train_step(tcfg, W, estimator=Estimator(method, beta=beta),
                            mode=mode, optimizer=topt, byzantine_frac=byz,
                            attack=attack, device="cpu")
    tp = tparams(jp, tcfg)
    to = topt.init(tp)
    n_byz = int(byz * (W - 1))
    jest = JEstimator(method, beta=beta, backend="ref")
    for i in range(3):
        jp, jo, jl = RC.step(jcfg, jp, jo, j_lm_batch(jcfg, i, BATCH, SEQ),
                             jest, attack, n_byz, jopt, mode, W)
        tp, to, tl = setup.step_fn(tp, to, _tbatch(tcfg, i))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-5)
    close_tree(jp, tp, 2e-5)
    close_tree(jo["m"], to["m"], 2e-5)
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("attack", ["none", "signflip"])
def test_vrmom_on_repro_stack(attack):
    """VRMOM (K 10) of ``repro``'s own per-worker gradient stack of the moe
    model, clean and with the last row sign-flipped: the port's stacked
    aggregate equals ``repro``'s, every leaf (router and experts too)."""
    jcfg, _, jp = _models()
    jb = j_lm_batch(jcfg, 0, BATCH, SEQ)
    _, g = RC.stack(jcfg, jp, jb, W)
    if attack != "none":
        mask = jnp.arange(W) >= W - 1
        g = jax.tree.map(lambda x: JA.get(attack)(None, x, mask), g)
    want = JRR.aggregate_stacked_auto(g, JEstimator("vrmom", K=10,
                                                    backend="ref"))
    tg = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), g)
    close_tree(want, RR.aggregate_stacked_auto(tg, Estimator("vrmom",
                                                              K=10)), 1e-5)


@pytest.mark.parametrize("attack,byz", [("none", 0.0), ("signflip", 0.4)])
def test_three_vrmom_steps_on_repro_stacks(monkeypatch, attack, byz):
    """VRMOM (K 10) through three of the port's stacked-auto steps, each
    fed ``repro``'s own per-worker stack of that step at ``repro``'s params
    (the port's own stack parts from it by ~1e-7, where VRMOM's count can
    jump): the port's attack, aggregate and SGD carry against ``repro``'s,
    the params and the momentum after the three steps."""
    jcfg, tcfg, jp = _models()
    jopt = JO.get("sgd", lr=0.5, momentum=0.9)
    topt = TO.get("sgd", lr=0.5, momentum=0.9)
    jo = jopt.init(jp)
    setup = make_train_step(tcfg, W, estimator=Estimator("vrmom", K=10),
                            mode="stacked-auto", optimizer=topt,
                            byzantine_frac=byz, attack=attack, device="cpu")
    tp = tparams(jp, tcfg)
    to = topt.init(tp)
    n_byz = int(byz * (W - 1))
    jest = JEstimator("vrmom", K=10, backend="ref")
    for i in range(3):
        jb = j_lm_batch(jcfg, i, BATCH, SEQ)
        losses, g = RC.stack(jcfg, jp, jb, W)
        fed = (torch.tensor(float(jnp.mean(losses))),
               jax.tree.map(lambda x: torch.from_numpy(np.array(x)), g))
        monkeypatch.setattr(TS, "stacked_grads",
                            lambda *a, fed=fed, **k: fed)
        jp, jo, jl = RC.step(jcfg, jp, jo, jb, jest, attack, n_byz, jopt,
                             "stacked-auto", W)
        tp, to, tl = setup.step_fn(tp, to, _tbatch(tcfg, i))
        assert float(tl) == float(fed[0])
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    close_tree(jp, tp, 2e-5)
    close_tree(jo["m"], to["m"], 2e-5)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_stacked_grads_are_each_workers_own():
    """Row w of each leaf's stack is worker w's own gradient, bitwise: the
    loss and grads of its slice of the batch alone, so a worker's routing
    groups never mix with another's (each routes the same with and
    without the others' rows beside it)."""
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 4)
    (loss, stack), together = _routings(lambda: stacked_grads(tcfg, tp, b,
                                                              W))
    per = BATCH // W
    losses, alone = [], []
    for w in range(W):
        (lw, gw), rw = _routings(lambda: loss_and_grads(
            tcfg, tp, {k: v[w * per:(w + 1) * per] for k, v in b.items()}))
        losses.append(lw)
        alone.extend(rw)
        for path, s in paths(stack):
            assert torch.equal(s[w], at(gw, path)), path
    assert torch.equal(loss, torch.mean(torch.stack(losses)))
    assert len(together) == len(alone) == W * tcfg.n_layers
    for a, b_ in zip(together, alone):
        assert torch.equal(a.expert, b_.expert) and torch.equal(a.pos,
                                                                b_.pos)
    assert not all(bool(r.keep.all()) for r in alone)  # capacity binds


# ---------------------------------------------------------------------------
# remat: the recompute routes as the forward did
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_loss_grads(seq, chunk, remat):
    """``jax.value_and_grad(repro.models.model.loss)`` on the reduced model
    with ``MOE_SEQ_CHUNK`` = ``chunk`` while it traces."""
    jcfg, _, jp = _models()
    jcfg = dataclasses.replace(jcfg, remat=remat)
    jb = j_lm_batch(jcfg, 6, 2, seq)
    real = JX.MOE_SEQ_CHUNK
    JX.MOE_SEQ_CHUNK = chunk
    try:
        return jax.value_and_grad(lambda p: JM.loss(p, jcfg, jb))(jp)
    finally:
        JX.MOE_SEQ_CHUNK = real


@pytest.mark.parametrize("remat_block", [1, 2])
def test_remat_recompute_routes_as_the_forward(monkeypatch, remat_block):
    """With ``MOE_SEQ_CHUNK`` 16 in both packages a 32-token row routes
    as two groups of capacity int(1.25 * 8 * 16 / 40) = 4, slots dropped.
    Under remat (each layer, or a block of both, recomputed in the
    backward) the recompute makes the forward's routing decisions, call
    for call, and the loss and every gradient equal remat off's at 1e-6
    and ``repro``'s (remat on) at 1e-4."""
    monkeypatch.setattr(TX, "MOE_SEQ_CHUNK", 16)
    _, tcfg, jp = _models()
    seq = 32
    jl, jg = _j_loss_grads(seq, 16, True)
    tp = tparams(jp, tcfg)
    tb = _tbatch(tcfg, 6, 2, seq)
    plain, fwd = _routings(lambda: loss_and_grads(tcfg, tp, tb))
    rcfg = dataclasses.replace(tcfg, remat=True, remat_block=remat_block)
    (rl, rg), calls = _routings(lambda: loss_and_grads(rcfg, tp, tb))
    L = tcfg.n_layers
    assert len(fwd) == L and len(calls) > L
    assert all(r.expert.shape == (2 * 2, 16, 8) and r.capacity == 4
               for r in calls)
    assert not all(bool(r.keep.all()) for r in fwd)

    def same(a, b):
        return torch.equal(a.expert, b.expert) and torch.equal(a.pos, b.pos)

    # the forward's calls, then the backward's recomputes (a block's, and
    # each layer's inside it), each the routing of one forward layer, and
    # every layer recomputed
    assert all(same(a, b) for a, b in zip(fwd, calls[:L]))
    redo = [[i for i, a in enumerate(fwd) if same(a, r)] for r in calls[L:]]
    assert all(len(i) == 1 for i in redo)
    assert sorted({i[0] for i in redo}) == list(range(L))
    np.testing.assert_allclose(float(rl), float(plain[0]), rtol=1e-6,
                               atol=1e-6)
    for (path, a), b in zip(paths(plain[1]), _leaves(rg)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6,
                                   msg=str(path))
    np.testing.assert_allclose(float(rl), float(jl), rtol=1e-5, atol=1e-5)
    close_tree(jg, rg, 1e-4)


def test_a_recompute_that_routes_otherwise_is_flagged(monkeypatch):
    """A planted fault: under remat the backward's recompute routes from a
    perturbed router, as a recompute that does not replay the forward's
    inputs would. The loss is the forward's, bit for bit, so no loss gate
    can see it; the moe leaves' gradients part from the true ones, and
    ``chip_smoke.recompute_routes`` (phase 14's gate on the card) matches
    the recomputes to no forward layer."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(TX, "MOE_SEQ_CHUNK", 16)
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    tb = _tbatch(tcfg, 6, 2, 32)
    rcfg = dataclasses.replace(tcfg, remat=True, remat_block=1)
    L = tcfg.n_layers
    (l0, g0), calls0 = _routings(lambda: loss_and_grads(rcfg, tp, tb))
    redo0 = smoke.recompute_routes(calls0, L)
    assert len(calls0) == 2 * L and sorted(m[0] for m in redo0
                                           if len(m) == 1) == list(range(L))
    real, n = TX.route, [0]

    def misrouted(x, router, cfg):
        n[0] += 1
        if n[0] > L:  # the backward's recomputes
            with torch.no_grad():  # a constant: autograd saves no more
                g = torch.Generator().manual_seed(n[0])
                noise = router.std() * torch.randn(router.shape, generator=g)
            router = router + noise
        return real(x, router, cfg)

    monkeypatch.setattr(TX, "route", misrouted)
    (l1, g1), calls1 = _routings(lambda: loss_and_grads(rcfg, tp, tb))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a.expert, b.expert)
               for a, b in zip(calls0[:L], calls1[:L]))
    assert not any(len(m) == 1 for m in smoke.recompute_routes(calls1, L))
    for k in MOE_LEAVES:
        a, b = g0["layers"]["moe"][k], g1["layers"]["moe"][k]
        assert float((a - b).abs().max()) > 1e-2 * float(a.abs().max()), k


# ---------------------------------------------------------------------------
# inloop: the attention's products and the unembedding on the wire; the
# router and the experts plain products in both packages
# ---------------------------------------------------------------------------

def test_inloop_wire_leaves_the_router_and_experts_plain(monkeypatch):
    """Recorded and pinned (ROADMAP.md §C): only 3-D x 2-D products reach
    the wire, so a moe model's router and expert gradients are the plain
    batch gradient in both packages (the port's bitwise), while the
    attention's products are each worker's median (W x the inloop dW = the
    median of the stacked workers' own grads); the port's inloop
    gradients equal ``repro``'s wire at 1e-4, every leaf."""
    jcfg, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 1)
    jb = j_lm_batch(jcfg, 1, BATCH, SEQ)
    _, plain = loss_and_grads(tcfg, tp, b)
    _, stack = stacked_grads(tcfg, tp, b, W)
    with RR.robust_backward(W, "median"):
        _, inloop = loss_and_grads(tcfg, tp, b)
    for k in MOE_LEAVES:
        assert torch.equal(inloop["layers"]["moe"][k],
                           plain["layers"]["moe"][k]), k
    for k in ATTN_LEAVES:
        # reprolint-torch: disable=RL001 oracle: the stack's median
        want = torch.quantile(stack["layers"]["attn"][k], 0.5, dim=0)
        got = inloop["layers"]["attn"][k] * W
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * float(want.abs().max()), msg=k)
        assert not torch.allclose(got / W, plain["layers"]["attn"][k],
                                  rtol=1e-3, atol=0), k
    j_plain = RC.grads(monkeypatch, jcfg, jp, jb, W)
    j_inloop = RC.grads(monkeypatch, jcfg, jp, jb, W, "median")
    for k in MOE_LEAVES:
        np.testing.assert_allclose(
            np.asarray(j_inloop["layers"]["moe"][k]),
            np.asarray(j_plain["layers"]["moe"][k]), rtol=1e-6, atol=1e-6,
            err_msg=k)
    close_tree(j_inloop, inloop, 1e-4)


@pytest.mark.parametrize("remat,seq", [(False, SEQ), (True, 40)])
def test_inloop_aggregates_each_product_once(monkeypatch, remat, seq):
    """One aggregate of a ``[W, D, F]`` dW stack per product and step,
    under remat too: q, k, v, o a layer and the tied unembedding once a
    loss chunk (40 tokens: two chunks of 32), 4 * L + ceil(seq / 32); no
    router or expert product."""
    _, tcfg, jp = _models()
    tcfg = dataclasses.replace(tcfg, remat=remat)
    seen = []
    agg = RR.aggregate_stacked_auto

    def counted(x, est, **kw):
        seen.append(tuple(x.shape))
        return agg(x, est, **kw)

    monkeypatch.setattr(RR, "aggregate_stacked_auto", counted)
    setup = make_train_step(tcfg, W, estimator="vrmom", mode="inloop",
                            lr=1e-2, device="cpu")
    tp = tparams(jp, tcfg)
    _, _, loss = setup.step_fn(tp, setup.optimizer.init(tp),
                               _tbatch(tcfg, 3, BATCH, seq))
    assert np.isfinite(float(loss))
    D, H, Hkv, dh = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.head_dim
    per_layer = [(W, D, H * dh), (W, D, Hkv * dh), (W, D, Hkv * dh),
                 (W, H * dh, D)]
    chunks = -(-seq // tcfg.loss_chunk)
    assert len(seen) == 4 * tcfg.n_layers + chunks
    assert sorted(seen) == sorted(per_layer * tcfg.n_layers
                                  + [(W, D, tcfg.vocab)] * chunks)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stacked-auto", "inloop"])
def test_launcher_granite_reduced_on_the_cpu(tmp_path, mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", NAME,
         "--reduced", "--device", "cpu", "--steps", "2", "--workers", "4",
         "--seq", "24", "--byzantine", "0.25", "--attack", "signflip",
         "--mode", mode, "--metrics", str(tmp_path / "m.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=granite-moe-3b-a800m-smoke ")
    assert "workers=4" in lines[0] and f"mode={mode}" in lines[0]
    steps = [ln.split() for ln in lines[1:3]]
    assert [s[:2] for s in steps] == [["step", "0"], ["step", "1"]]
    assert all(np.isfinite(float(s[3])) for s in steps)
    recs = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(recs) == 2
    assert ('"agg.alpha_hat"' in recs[-1]) == (mode != "inloop")
