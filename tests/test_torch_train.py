"""repro_torch training: the reduced qwen3 (and the vlm) against ``repro``.

``repro``'s seeded params go through ``convert.params_from_jax``, so both
sides start from the same function; the data is ``lm_batch`` on both
sides. ``repro``'s ``make_train_step`` needs a mesh of several devices,
which this process does not have, so the port's step is held against the
mesh-free composition of ``repro``'s own pieces on one device
(``repro_compose``): ``jax.vmap(jax.value_and_grad(model.loss))`` over
the workers, the attack of ``repro.core.attacks``,
``robust_reduce.aggregate_stacked_auto`` and ``repro.optim``'s update. ``repro``'s Estimator runs its ``ref`` oracle
(the semantics its Pallas kernel is tested against) to keep the test
short.

Tolerances: the loss at 1e-5 and its gradients at 1e-4 (absolute and
relative; XLA and PyTorch sum in other orders, observed ~2e-7). Three
train steps at 2e-5 on the params with the mean, the median and the
trimmed mean under deterministic attacks, updated by SGD with momentum
(linear in the gradient; AdamW's parity is on equal gradients, in
``test_torch_optim.py``). VRMOM is not continuous in its
input (its count of z <= Delta_k jumps), so it is held on ``repro``'s own
per-worker stack at 1e-5, and the random attacks (gaussian, bitflip) as
a robustness contract, since JAX's PRNG and ``torch.Generator`` never
draw alike. Diagnostics at 1e-6, the suspected mask exactly.
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
from repro.core import attacks as JA
from repro.core.estimator import Estimator as JEstimator
from repro.data import lm_batch as j_lm_batch
from repro.dist import robust_reduce as JRR
from repro.models import model as JM
from repro.obs import diag as JD
from repro_torch import optim as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.core.estimator import Estimator
from repro_torch.data import lm_batch
from repro_torch.dist import robust_reduce as RR
from repro_torch.models import model as TM
from repro_torch.obs import diag as TD
from repro_torch.train.step import (loss_and_grads, make_train_step,
                                    stacked_grads)
from repro_torch.tree import leaves as _leaves

import repro_compose as RC
from repro_compose import close_tree, tparams

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
W = 4
BATCH, SEQ = 8, 24


def _cfgs(name="qwen3-1.7b", **kw):
    return (dataclasses.replace(j_get_arch(name).reduced(), **kw),
            dataclasses.replace(t_get_arch(name).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _models(name="qwen3-1.7b"):
    jcfg, tcfg = _cfgs(name)
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


def _jbatch(cfg, step, batch=BATCH, seq=SEQ):
    return j_lm_batch(cfg, step, batch, seq)


def _tbatch(cfg, step, batch=BATCH, seq=SEQ):
    return lm_batch(cfg, step, batch, seq, device="cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,seq", [("qwen3-1.7b", 24),
                                      ("phi-3-vision-4.2b", 20)])
def test_lm_batch_bitwise(name, seq):
    """Tokens (and a vlm's stub patches) equal ``repro``'s bit for bit, in
    the reduced (f32) and the full-width (bf16 patches) configs."""
    for cfg_j, cfg_t in ((j_get_arch(name).reduced(),
                          t_get_arch(name).reduced()),
                         (j_get_arch(name), t_get_arch(name))):
        for step, seed in ((0, 0), (7, 3)):
            jb = j_lm_batch(cfg_j, step, 3, seq, seed)
            tb = lm_batch(cfg_t, step, 3, seq, seed, device="cpu")
            assert sorted(jb) == sorted(tb)
            assert tb["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(tb["tokens"].numpy(),
                                          np.asarray(jb["tokens"]))
            if "patches" in jb:
                want = np.asarray(jb["patches"])
                got = tb["patches"]
                assert str(got.dtype).split(".")[-1] == want.dtype.name
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy() if got.dtype
                    == torch.bfloat16 else got.numpy(),
                    want.view(np.int16) if want.dtype.name == "bfloat16"
                    else want)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JM.loss(p, jcfg, b)))


@pytest.mark.parametrize("name,remat,block,seq", [
    ("qwen3-1.7b", False, 1, 40),   # 40 is not a multiple of loss_chunk 32
    ("qwen3-1.7b", True, 1, 40),
    ("qwen3-1.7b", True, 2, 40),    # two-level remat: a block of 2 layers
    ("phi-3-vision-4.2b", True, 1, 44)])
def test_loss_and_grads_match(name, remat, block, seq):
    jcfg, tcfg, jp = _models(name)
    jcfg = dataclasses.replace(jcfg, remat=remat, remat_block=block)
    tcfg = dataclasses.replace(tcfg, remat=remat, remat_block=block)
    jb = _jbatch(jcfg, 1, 2, seq)
    jl, jg = _j_value_and_grad(jcfg)(jp, jb)
    tl, tg = loss_and_grads(tcfg, tparams(jp, tcfg), _tbatch(tcfg, 1, 2, seq))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    close_tree(jg, tg, 1e-4)
    # and through the model API, forward only
    with torch.no_grad():
        l2 = TM.loss(tparams(jp, tcfg), tcfg, _tbatch(tcfg, 1, 2, seq))
    np.testing.assert_allclose(float(l2), float(jl), rtol=1e-5, atol=1e-5)


def test_microbatch_accumulation_matches_repro_scan():
    """Two micro-steps: gradients summed in f32, averaged, cast back."""
    jcfg, tcfg, jp = _models()
    jb = _jbatch(jcfg, 2, 4, SEQ)
    l0, g0 = _j_value_and_grad(jcfg)(jp, {"tokens": jb["tokens"][:2]})
    l1, g1 = _j_value_and_grad(jcfg)(jp, {"tokens": jb["tokens"][2:]})
    tl, tg = loss_and_grads(tcfg, tparams(jp, tcfg), _tbatch(tcfg, 2, 4),
                            micro=2)
    np.testing.assert_allclose(float(tl), float(l0 + l1) / 2, rtol=1e-5,
                               atol=1e-5)
    close_tree(jax.tree.map(lambda a, b: (a + b) / 2, g0, g1), tg, 1e-4)


def test_flash_attention_fn_grads_match_mha():
    """attn_backend='flash' under autograd: FlashAttentionFn (B2's plain
    version on the CPU, the backward recomputed through ``mha``) gives the
    plain backend's gradients — the counterpart of ``repro``'s
    ``test_flash_full_attention_grad``."""
    _, tcfg, jp = _models()
    b = _tbatch(tcfg, 1, 2, 16)
    grads = {}
    for backend in ("torch", "flash"):
        c = dataclasses.replace(tcfg, attn_backend=backend)
        grads[backend] = loss_and_grads(c, tparams(jp, c), b)[1]
    for a, g in zip(_leaves(grads["torch"]), _leaves(grads["flash"])):
        torch.testing.assert_close(g, a, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the stacked step against repro's mesh-free composition
# ---------------------------------------------------------------------------

CASES = [  # (mode, estimator method, attack, byzantine fraction)
    ("stacked-rrs", "mean", "none", 0.0),
    ("stacked-auto", "median", "signflip", 0.4),
    ("stacked-rrs", "trimmed_mean", "zero", 0.4),
    ("stacked-auto", "median", "omniscient", 0.4),
    ("stacked-rrs", "trimmed_mean", "alie", 0.4),
    ("stacked-auto", "median", "ipm", 0.4),
    ("stacked-rrs", "trimmed_mean", "mimic", 0.4),
    ("stacked-auto", "median", "wrong_value", 0.4),
    ("mean", "mean", "signflip", 0.4),
]


@pytest.mark.parametrize("mode,method,attack,byz", CASES)
def test_three_stacked_steps_match_repro(mode, method, attack, byz):
    jcfg, tcfg, jp = _models()
    beta = 0.25  # trims one of 4 rows a side
    # SGD with momentum: AdamW's m / sqrt(v) turns float noise in a
    # near-zero gradient into a step of ~lr (its own parity, on equal
    # grads, is tests/test_torch_optim.py)
    jopt = JO.get("sgd", lr=0.5, momentum=0.9)
    topt = TO.get("sgd", lr=0.5, momentum=0.9)
    jo = jopt.init(jp)
    setup = make_train_step(tcfg, W, estimator=Estimator(method, beta=beta),
                            mode=mode, optimizer=topt, byzantine_frac=byz,
                            attack=attack, device="cpu")
    tp = tparams(jp, tcfg)
    to = topt.init(tp)
    n_byz = int(byz * (W - 1))
    jest = JEstimator(method, beta=beta, backend="ref")
    for i in range(3):
        jp, jo, jl = RC.step(jcfg, jp, jo, _jbatch(jcfg, i), jest, attack,
                             n_byz, jopt, mode, W)
        tp, to, tl = setup.step_fn(tp, to, _tbatch(tcfg, i))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-5)
    close_tree(jp, tp, 2e-5)
    close_tree(jo["m"], to["m"], 2e-5)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_vrmom_on_repro_stack():
    """VRMOM (K 10 and 8, and under an attack) of ``repro``'s own
    per-worker gradient stack: the port's aggregate equals ``repro``'s."""
    jcfg, tcfg, jp = _models()
    _, g = RC.stack(jcfg, jp, _jbatch(jcfg, 0), W)
    mask = jnp.arange(W) >= W - 1
    for K, attack in ((10, "none"), (8, "signflip")):
        if attack != "none":
            g = jax.tree.map(lambda x: JA.get(attack)(None, x, mask), g)
        want = JRR.aggregate_stacked_auto(g, JEstimator("vrmom", K=K,
                                                        backend="ref"))
        tg = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), g)
        got = RR.aggregate_stacked_auto(tg, Estimator("vrmom", K=K))
        close_tree(want, got, 1e-5)


def test_vrmom_step_runs_and_descends():
    """The port's stacked-rrs step with VRMOM takes steps (finite loss)."""
    _, tcfg, jp = _models()
    setup = make_train_step(tcfg, W, estimator="vrmom", lr=1e-2,
                            device="cpu")
    tp = tparams(jp, tcfg)
    to = setup.optimizer.init(tp)
    losses = []
    for i in range(3):
        tp, to, loss = setup.step_fn(tp, to, _tbatch(tcfg, 0))
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_random_attacks_keep_vrmom_robust():
    """gaussian and bitflip: draws differ from JAX's, so what is held is
    the contract, at 8 workers with 2 attacked: VRMOM's aggregate moves
    by at most half the honest rows' RMS distance from the clean aggregate
    (bounded influence; measured 0.03-0.26), the mean's by over 100 times
    it under gaussian noise (measured 364)."""
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    _, stack = stacked_grads(tcfg, tp, _tbatch(tcfg, 0, 16), 8)
    from repro_torch.core import attacks as TA

    mask = torch.arange(8) >= 8 - int(0.25 * 7)
    gen = torch.Generator().manual_seed(0)

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in _leaves(tree)])

    rows = torch.stack([torch.cat([t[w].reshape(-1) for t in _leaves(stack)])
                        for w in range(8)])
    for attack in ("gaussian", "bitflip"):
        attacked = RR.tree_map(lambda g: TA.get(attack)(gen, g, mask), stack)
        for method in ("vrmom", "mean"):
            clean = flat(RR.aggregate(stack, mode="stacked-auto",
                                      est=method))
            hit = flat(RR.aggregate(attacked, mode="stacked-auto",
                                    est=method))
            spread = torch.sqrt(torch.mean(torch.sum(
                (rows - clean[None]) ** 2, dim=1)))
            ratio = float(torch.linalg.vector_norm(hit - clean) / spread)
            if method == "vrmom":
                assert ratio <= 0.5, (attack, ratio)
            elif attack == "gaussian":
                assert ratio >= 100.0, (attack, ratio)


def test_train_step_robust_vs_byzantine():
    """``repro``'s ``test_train_step_robust_vs_byzantine`` contract on one
    CPU device with 4 emulated workers: VRMOM trains through the
    omniscient attack at 0.4, the mean diverges."""
    _, tcfg, jp = _models()

    def run(aggregator, byz):
        setup = make_train_step(tcfg, W, estimator=aggregator, lr=1e-2,
                                byzantine_frac=byz, attack="omniscient",
                                device="cpu")
        p = tparams(jp, tcfg)
        st = setup.optimizer.init(p)
        losses = []
        for i in range(8):
            p, st, loss = setup.step_fn(p, st, _tbatch(tcfg, i, 8, 32))
            losses.append(float(loss))
        return losses, p

    l_clean, _ = run("vrmom", 0.0)
    assert l_clean[-1] < l_clean[0]
    l_byz, p_byz = run("vrmom", 0.4)
    assert np.isfinite(l_byz).all()
    assert np.isfinite(float(sum((x.float() ** 2).sum()
                                 for x in _leaves(p_byz))))
    assert l_byz[-1] < l_byz[0] + 0.3
    l_mean, _ = run("mean", 0.4)
    assert (not np.isfinite(l_mean[-1])) or l_mean[-1] > l_mean[0] + 1.0
    assert (not np.isfinite(l_mean[-1])) or l_mean[-1] > l_byz[-1] + 1.0


# ---------------------------------------------------------------------------
# in-backward aggregation
# ---------------------------------------------------------------------------

def _robust_dot_case(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(8, 6, 10).astype(np.float32)   # batch 8 = 4 workers x 2
    w = rs.randn(10, 12).astype(np.float32)
    dy = rs.randn(8, 6, 12).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("method", ["vrmom", "median", "mean"])
def test_robust_dot_dw_is_the_aggregate_of_worker_dw(method):
    """dW of robust_dot = the estimator over per-worker dW (what
    ``repro``'s ``test_inloop_robust_dot`` computes, without its mesh), dx
    the plain one."""
    x, w, dy = _robust_dot_case()
    dws = jnp.einsum("wbsd,wbsf->wdf", x.reshape(W, 2, 6, 10),
                     dy.reshape(W, 2, 6, 12))
    want = JRR.aggregate_stacked_auto(dws, JEstimator(method,
                                                      backend="ref"))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    with RR.robust_backward(W, method):
        assert RR.robust_dot_enabled()
        y = RR.robust_dot(xt, wt)
    assert not RR.robust_dot_enabled()
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), dy @ w.T, rtol=1e-5,
                               atol=1e-5)


def test_robust_dot_refuses_a_batch_the_workers_do_not_divide():
    x, w, dy = _robust_dot_case()
    xt = torch.from_numpy(x[:6]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    with RR.robust_backward(W, "vrmom"):
        y = RR.robust_dot(xt, wt)
    with pytest.raises(ValueError, match="not divisible by the 4 workers"):
        y.sum().backward()


def test_inloop_weight_grads_carry_one_over_w():
    """Recorded and pinned (ROADMAP.md §C): ``repro``'s in-backward dW
    aggregates the workers' partial sums of the global loss's dW, so with
    the mean it is the global dW / W, while a leaf outside the products
    (the norms) gets the full gradient. Both packages: ``repro``'s formula
    on the robust_dot case, the port on the whole model."""
    x, w, dy = _robust_dot_case()
    dws = jnp.einsum("wbsd,wbsf->wdf", x.reshape(W, 2, 6, 10),
                     dy.reshape(W, 2, 6, 12))
    j_mean = JRR.aggregate_stacked_auto(dws, JEstimator("mean",
                                                        backend="ref"))
    np.testing.assert_allclose(np.asarray(j_mean) * W,
                               np.einsum("bsd,bsf->df", x, dy),
                               rtol=1e-4, atol=1e-4)
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 0)
    _, plain = loss_and_grads(tcfg, tp, b)
    with RR.robust_backward(W, "mean"):
        _, inloop = loss_and_grads(tcfg, tp, b)
    for leaf in ("w_gate", "w_down"):
        torch.testing.assert_close(inloop["layers"]["mlp"][leaf] * W,
                                   plain["layers"]["mlp"][leaf],
                                   rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(inloop["layers"]["norm_ffn"],
                               plain["layers"]["norm_ffn"], rtol=1e-4,
                               atol=1e-6)


def test_inloop_step_and_its_refusals():
    _, tcfg, jp = _models()
    setup = make_train_step(tcfg, W, estimator="vrmom", mode="inloop",
                            lr=1e-2, device="cpu")
    tp = tparams(jp, tcfg)
    to = setup.optimizer.init(tp)
    losses = []
    for i in range(2):
        tp, to, loss = setup.step_fn(tp, to, _tbatch(tcfg, 0))
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    # the strided micro-split: 2 micro-steps of one sequence per worker
    micro = make_train_step(tcfg, W, estimator="vrmom", mode="inloop",
                            microbatch=2, device="cpu")
    p2 = tparams(jp, tcfg)
    _, _, loss = micro.step_fn(p2, micro.optimizer.init(p2), _tbatch(tcfg, 0))
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="with_diag is unavailable"):
        make_train_step(tcfg, W, mode="inloop", with_diag=True, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        setup.step_fn(tp, to, _tbatch(tcfg, 0, 6))
    # the consensus backend runs (tests/test_torch_consensus.py); at W = 4
    # the default f = 1 is refused at build (n > 5f), f = 0 steps
    from repro_torch.dist.consensus import ConsensusConfig

    with pytest.raises(ValueError, match="n > 5f"):
        make_train_step(tcfg, W, reduce_backend="consensus", device="cpu")
    cons = make_train_step(tcfg, W, reduce_backend="consensus",
                           consensus=ConsensusConfig(f=0), device="cpu")
    p3 = tparams(jp, tcfg)
    _, _, loss, caux = cons.step_fn(p3, cons.optimizer.init(p3),
                                    _tbatch(tcfg, 0))
    assert np.isfinite(float(loss)) and not bool(caux.quorum_lost)
    # the adaptive tier needs the stacked wire, as in repro
    with pytest.raises(ValueError, match="materialized stacked wire"):
        make_train_step(tcfg, W, estimator="vrmom_adaptive", mode="inloop",
                        device="cpu")
    # at 8 workers (at W = 4 the n > 5f refusal comes first, as in repro)
    with pytest.raises(ValueError, match="consensus backend"):
        make_train_step(tcfg, 8, estimator="auto_gm",
                        reduce_backend="consensus", device="cpu")
    with pytest.raises(ValueError, match="n > 5f"):
        RR.aggregate({"a": torch.zeros(4, 3)}, mode="stacked-consensus")
    out, _ = RR.aggregate({"a": torch.ones(4, 3)}, mode="stacked-consensus",
                          consensus=ConsensusConfig(f=0))
    assert torch.equal(out["a"], torch.ones(3))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", ["none", "omniscient", "signflip"])
def test_tree_diagnose_matches_repro(attack):
    rs = np.random.RandomState(3)
    tree = {"a": rs.randn(8, 6, 5).astype(np.float32),
            "b": {"c": rs.randn(8, 7).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    if attack != "none":
        mask = jnp.arange(8) >= 6
        jt = jax.tree.map(lambda x: JA.get(attack)(None, x, mask), jt)
    jagg = JRR.aggregate_stacked_auto(jt, JEstimator("vrmom",
                                                     backend="ref"))
    want = JD.tree_diagnose(jt, jagg)
    tt = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), jt)
    tagg, got = RR.aggregate(tt, mode="stacked-auto", est="vrmom",
                             with_diag=True)
    for f in ("scores", "alpha_hat", "pre_norms", "post_norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.suspected.numpy(),
                                  np.asarray(want.suspected))
    if attack == "omniscient":
        assert got.suspected.numpy().tolist() == [False] * 6 + [True] * 2
    one = TD.diagnose(tt["a"], tagg["a"])
    jone = JD.diagnose(jt["a"], jagg["a"])
    np.testing.assert_allclose(one.scores.numpy(), np.asarray(jone.scores),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(one.suspected.numpy(),
                                  np.asarray(jone.suspected))


def test_step_with_diag_flags_the_attacked_workers():
    """int(0.3 * 7) = 2 of 8 workers attacked (``repro``'s rule; at 0.25
    it is int(1.75) = 1): the diagnostics flag exactly those two."""
    _, tcfg, jp = _models()
    setup = make_train_step(tcfg, 8, estimator="vrmom", with_diag=True,
                            byzantine_frac=0.3, attack="omniscient",
                            device="cpu")
    tp = tparams(jp, tcfg)
    _, _, loss, diag = setup.step_fn(tp, setup.optimizer.init(tp),
                                     _tbatch(tcfg, 0, 16))
    assert np.isfinite(float(loss))
    assert diag.suspected.tolist() == [False] * 6 + [True] * 2
    assert float(diag.alpha_hat) == 0.25


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_reduced_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "2",
         "--workers", "4", "--byzantine", "0.25", "--attack", "signflip",
         "--metrics", str(tmp_path / "m.jsonl"),
         "--checkpoint", str(tmp_path / "ck")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen3-1.7b-smoke ")
    assert "workers=4" in lines[0] and "mode=stacked-rrs" in lines[0]
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"],
                                                     ["step", "1"]]
    recs = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(recs) == 2 and '"agg.alpha_hat"' in recs[-1]
    assert (tmp_path / "ck" / "arrays.npz").is_file()
