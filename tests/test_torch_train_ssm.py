"""repro_torch training of the ssm and hybrid families against ``repro``.

Both packages run mamba2-2.7b and zamba2-7b at their ``reduced()`` sizes
(mamba2: 2 layers, d_model 64; zamba2: 4 layers with the shared block
after every 2, so two applications and a tail of 0, where ``repro`` keeps
one ``mamba_t`` layer that nothing runs; an SSM block of d_state 16, head
dim 32, chunk 16; vocab 512, f32) at ``repro``'s seeded params
(``convert.params_from_jax``), on ``lm_batch``'s tokens. A 24-token row
is two chunks of 16, the second padded. As in ``test_torch_train_moe.py``,
``repro``'s ``make_train_step`` needs a mesh of several devices, so the
port's step is held against the mesh-free composition of ``repro``'s own
pieces (``repro_compose``): ``jax.vmap`` of ``jax.value_and_grad(model.loss)`` over the
workers, the attack of ``repro.core.attacks``,
``robust_reduce.aggregate_stacked_auto`` and ``repro.optim``'s update,
the Estimator on its ``ref`` oracle; its inloop wire is ``repro``'s
``_robust_dot_bwd`` with that mesh-free aggregate in place of the mesh's.

Tolerances: the loss at 1e-5, three train steps' params and momentum at
2e-5 (SGD with momentum: AdamW turns float noise in a near-zero gradient
into a step of ~lr) with the trimmed mean, the median and the mean;
VRMOM, whose count of z <= Delta_k jumps on 1e-7 input differences,
through three steps fed ``repro``'s stacks at 2e-5; remat on against
remat off at 1e-6 (the same arithmetic recomputed) and against ``repro``
at 1e-4 (``test_torch_ssm``'s f32 tolerance); a worker's row of the stack
bitwise its own gradients; the inloop gradients at 1e-4 against
``repro``'s wire, the mamba layers' and the shared block's ``in_proj``
gradients under the wire bitwise the plain batch gradient in the port and
at 1e-6 in ``repro``; the unused tail layer's gradient rows exactly zero
and its params moved by each optimizer exactly as ``repro``'s.
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
from repro.configs import get as j_get_arch
from repro.core.estimator import Estimator as JEstimator
from repro.data import lm_batch as j_lm_batch
from repro.models import model as JM
from repro_torch import optim as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.core.estimator import Estimator
from repro_torch.data import lm_batch
from repro_torch.dist import robust_reduce as RR
from repro_torch.train import step as TS
from repro_torch.train.step import (loss_and_grads, make_train_step,
                                    stacked_grads)
from repro_torch.tree import at, leaves as _leaves, paths

import repro_compose as RC
from repro_compose import close_tree, tparams

torch.set_num_threads(1)

NAMES = ["mamba2-2.7b", "zamba2-7b"]
REPO = Path(__file__).resolve().parent.parent
W = 4
BATCH, SEQ = 8, 24
# SGD's lr: the two packages' f32 gradients part by ~1e-5 of their
# largest entries (test_torch_ssm's 1e-4 tolerance), and momentum 0.9
# adds 1 + 1.9 + 2.71 of them over three steps
LR = 0.2


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, tcfg = j_get_arch(name).reduced(), t_get_arch(name).reduced()
    return jcfg, tcfg, JM.init(jax.random.PRNGKey(0), jcfg)


def _tbatch(cfg, step, batch=BATCH, seq=SEQ):
    return lm_batch(cfg, step, batch, seq, device="cpu")


def _wire_free(path) -> bool:
    """A leaf no product on the inloop wire reaches: the mamba layers'
    (plain einsums in ``repro``) and the shared block's ``in_proj``."""
    return path[0] in ("layers", "mamba_g", "mamba_t") or path[:2] == (
        "shared", "in_proj")


# ---------------------------------------------------------------------------
# the stacked step against repro's mesh-free composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,method,attack,byz", [
    ("stacked-auto", "trimmed_mean", "none", 0.0),
    ("stacked-auto", "median", "signflip", 0.4),
    ("mean", "mean", "signflip", 0.4),
])
@pytest.mark.parametrize("name", NAMES)
def test_three_stacked_steps_match_repro(name, mode, method, attack, byz):
    """Three steps of the port's ``make_train_step`` against ``repro``'s
    stack, attack, aggregate and SGD update: the loss each step, then the
    params and the momentum (the reduced hybrid's unused tail layer
    among them)."""
    jcfg, tcfg, jp = _models(name)
    jopt = JO.get("sgd", lr=LR, momentum=0.9)
    topt = TO.get("sgd", lr=LR, momentum=0.9)
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


@pytest.mark.parametrize("attack,byz", [("none", 0.0), ("signflip", 0.4)])
@pytest.mark.parametrize("name", NAMES)
def test_three_vrmom_steps_on_repro_stacks(monkeypatch, name, attack, byz):
    """VRMOM (K 10) through three of the port's stacked-auto steps, each
    fed ``repro``'s own per-worker stack of that step at ``repro``'s params
    (the port's own stack parts from it by ~1e-7, where VRMOM's count can
    jump): the port's attack, aggregate and SGD carry against ``repro``'s,
    the params and the momentum after the three steps."""
    jcfg, tcfg, jp = _models(name)
    jopt = JO.get("sgd", lr=LR, momentum=0.9)
    topt = TO.get("sgd", lr=LR, momentum=0.9)
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


@pytest.mark.parametrize("name", NAMES)
def test_stacked_grads_are_each_workers_own(name):
    """Row w of each leaf's stack is worker w's own gradient, bitwise: the
    loss and grads of its slice of the batch alone (every leaf, the
    hybrid's unused tail layer a zero row)."""
    _, tcfg, jp = _models(name)
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 4)
    loss, stack = stacked_grads(tcfg, tp, b, W)
    per = BATCH // W
    losses = []
    for w in range(W):
        lw, gw = loss_and_grads(
            tcfg, tp, {k: v[w * per:(w + 1) * per] for k, v in b.items()})
        losses.append(lw)
        for path, s in paths(stack):
            assert torch.equal(s[w], at(gw, path)), path
    assert torch.equal(loss, torch.mean(torch.stack(losses)))


# ---------------------------------------------------------------------------
# remat: several chunks, the last padded
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_loss_grads(name, seq):
    jcfg, _, jp = _models(name)
    jcfg = dataclasses.replace(jcfg, remat=True)
    jb = j_lm_batch(jcfg, 6, 2, seq)
    return jax.value_and_grad(lambda p: JM.loss(p, jcfg, jb))(jp)


@pytest.mark.parametrize("name", NAMES)
def test_remat_matches_no_remat_and_repro(name):
    """40 tokens at chunk 16 (three chunks, the last padded by 8): with
    each mamba layer recomputed in the backward the loss and every
    gradient equal remat off's at 1e-6 and ``repro``'s (remat on) at
    1e-4."""
    _, tcfg, jp = _models(name)
    seq = 40
    jl, jg = _j_loss_grads(name, seq)
    tp = tparams(jp, tcfg)
    tb = _tbatch(tcfg, 6, 2, seq)
    assert seq % tcfg.ssm.chunk and seq // tcfg.ssm.chunk == 2
    pl, pg = loss_and_grads(tcfg, tp, tb)
    rl, rg = loss_and_grads(dataclasses.replace(tcfg, remat=True), tp, tb)
    np.testing.assert_allclose(float(rl), float(pl), rtol=1e-6, atol=1e-6)
    for (path, a), b in zip(paths(pg), _leaves(rg)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6,
                                   msg=str(path))
    np.testing.assert_allclose(float(rl), float(jl), rtol=1e-5, atol=1e-5)
    close_tree(jg, rg, 1e-4)


# ---------------------------------------------------------------------------
# inloop: the shared block's attention and MLP and the tied unembedding on
# the wire; the mamba projections and the hybrid's in_proj plain products
# in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_inloop_wire_leaves_the_mamba_projections_plain(monkeypatch, name):
    """Recorded and pinned (ROADMAP.md §C): only 3-D x 2-D products reach
    the wire, so the mamba layers' gradients (their projections are
    plain einsums in ``repro``) and the shared block's ``in_proj`` are the
    plain batch gradient in both packages (the port's bitwise), while the
    wire's leaves are not; the port's inloop gradients equal ``repro``'s
    wire at 1e-4, every leaf."""
    jcfg, tcfg, jp = _models(name)
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 1)
    jb = j_lm_batch(jcfg, 1, BATCH, SEQ)
    _, plain = loss_and_grads(tcfg, tp, b)
    with RR.robust_backward(W, "median"):
        _, inloop = loss_and_grads(tcfg, tp, b)
    n_free = 0
    for (path, a), (_, g) in zip(paths(plain), paths(inloop)):
        if _wire_free(path):
            assert torch.equal(g, a), path
            n_free += 1
        elif path[0] != "norm_f" and not path[-1].startswith("norm"):
            assert not torch.allclose(g, a, rtol=1e-3, atol=0), path
    assert n_free == (12 if tcfg.family == "ssm" else 25)
    j_plain = RC.grads(monkeypatch, jcfg, jp, jb, W)
    j_inloop = RC.grads(monkeypatch, jcfg, jp, jb, W, "median")
    for (path, a), b_ in zip(jax.tree_util.tree_leaves_with_path(j_plain),
                             jax.tree.leaves(j_inloop)):
        keys = tuple(k.key for k in path)
        if _wire_free(keys):
            np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                                       rtol=1e-6, atol=1e-6, err_msg=keys)
    close_tree(j_inloop, inloop, 1e-4)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_inloop_aggregates_each_product_once(monkeypatch, name, remat):
    """One aggregate of a ``[W, D, F]`` dW stack per product and step,
    under remat too (the mamba layers recomputed; the shared block is
    not): the tied unembedding once a loss chunk (40 tokens: two chunks
    of 32) and, for the hybrid, q, k, v, o, gate, up and down once an
    application of the shared block; no mamba product, no ``in_proj``."""
    _, tcfg, jp = _models(name)
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
    seq = 40
    _, _, loss = setup.step_fn(tp, setup.optimizer.init(tp),
                               _tbatch(tcfg, 3, BATCH, seq))
    assert np.isfinite(float(loss))
    D, V = tcfg.d_model, tcfg.vocab
    chunks = -(-seq // tcfg.loss_chunk)
    want = [(W, D, V)] * chunks
    if tcfg.family == "hybrid":
        H, Hkv, dh, F = (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim,
                         tcfg.d_ff)
        G = tcfg.n_layers // tcfg.hybrid_attn_every
        want += [(W, D, H * dh), (W, D, Hkv * dh), (W, D, Hkv * dh),
                 (W, H * dh, D), (W, D, F), (W, D, F), (W, F, D)] * G
    assert sorted(seen) == sorted(want)


# ---------------------------------------------------------------------------
# the hybrid at tail 0: repro's unused mamba_t layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("mode", ["stacked-auto", "inloop"])
def test_hybrid_at_tail_0_trains_as_repro(monkeypatch, mode, opt):
    """The reduced zamba2 has tail 0: ``repro`` keeps one ``mamba_t``
    layer that nothing runs, and ``jax.value_and_grad`` gives it a zero
    gradient. The port's step trains it in stacked-auto (median) and
    inloop (median on the wire): every worker's ``mamba_t`` gradient row
    is exactly zero, three steps match ``repro``'s mesh-free composition
    (SGD with momentum: every leaf at 2e-5), and ``mamba_t`` moves exactly
    as ``repro``'s optimizer moves it (SGD: not at all; AdamW: by its
    weight decay alone)."""
    jcfg, tcfg, jp = _models("zamba2-7b")
    assert tcfg.n_layers % tcfg.hybrid_attn_every == 0
    kw = (dict(lr=LR, momentum=0.9) if opt == "sgd"
          else dict(lr=1e-2, weight_decay=0.1))
    jopt, topt = JO.get(opt, **kw), TO.get(opt, **kw)
    jo = jopt.init(jp)
    setup = make_train_step(tcfg, W, estimator="median", mode=mode,
                            optimizer=topt, device="cpu")
    tp = tparams(jp, tcfg)
    t0 = {k: v.clone() for k, v in tp["mamba_t"]["ssm"].items()}
    to = topt.init(tp)
    jest = JEstimator("median", backend="ref")
    if mode == "inloop":
        with RR.robust_backward(W, "median"):
            _, g = loss_and_grads(tcfg, tp, _tbatch(tcfg, 0))
    else:
        _, g = stacked_grads(tcfg, tp, _tbatch(tcfg, 0), W)
    for k, v in paths(g["mamba_t"]):
        assert v.dtype == at(tp["mamba_t"], k).dtype, k
        assert v.abs().max() == 0, k
    for i in range(3):
        jb = j_lm_batch(jcfg, i, BATCH, SEQ)
        if mode == "inloop":
            jg = RC.grads(monkeypatch, jcfg, jp, jb, W, "median")
            jp, jo = jopt.update(jg, jo, jp)
        else:
            jp, jo, _ = RC.step(jcfg, jp, jo, jb, jest, "none", 0, jopt,
                                mode, W)
        tp, to, tl = setup.step_fn(tp, to, _tbatch(tcfg, i))
        assert np.isfinite(float(tl))
    jt = jax.tree.map(np.asarray, jp["mamba_t"])
    close_tree(jt, tp["mamba_t"], 1e-6)
    for k, v in tp["mamba_t"]["ssm"].items():
        if opt == "sgd":
            assert torch.equal(v, t0[k]), k
        else:
            assert not torch.equal(v, t0[k]) or not t0[k].any(), k
    if opt == "sgd":
        close_tree(jp, tp, 2e-5)
        close_tree(jo["m"], to["m"], 2e-5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stacked-auto", "inloop"])
@pytest.mark.parametrize("name", NAMES)
def test_launcher_reduced_on_the_cpu(tmp_path, name, mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", name,
         "--reduced", "--device", "cpu", "--steps", "2", "--workers", "4",
         "--seq", "24", "--byzantine", "0.25", "--attack", "signflip",
         "--mode", mode, "--metrics", str(tmp_path / "m.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={name}-smoke ")
    assert "workers=4" in lines[0] and f"mode={mode}" in lines[0]
    steps = [ln.split() for ln in lines[1:3]]
    assert [s[:2] for s in steps] == [["step", "0"], ["step", "1"]]
    assert all(np.isfinite(float(s[3])) for s in steps)
    recs = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(recs) == 2
    assert ('"agg.alpha_hat"' in recs[-1]) == (mode != "inloop")
