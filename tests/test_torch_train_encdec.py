"""repro_torch training of the encdec family (whisper) against ``repro``.

Both packages run whisper-medium at its ``reduced()`` size (2 encoder and
2 decoder layers, d_model 128, 4 heads of 32 over 2 kv heads, 12 stub
frames) in f32 at ``repro``'s seeded params (``convert.params_from_jax``),
on ``lm_batch``'s tokens and frames, numpy-made and bitwise alike on both
sides. As in ``test_torch_train.py``, ``repro``'s ``make_train_step``
needs a mesh of several devices, so the port's step is held against the
mesh-free composition of ``repro``'s own pieces (``repro_compose``):
``jax.vmap`` of
``jax.value_and_grad(model.loss)`` over the workers (each with its
frames), the attack of ``repro.core.attacks``,
``robust_reduce.aggregate_stacked_auto`` and ``repro.optim``'s update,
the Estimator on its ``ref`` oracle.

Tolerances: the loss at 1e-5, three train steps' params and momentum at
2e-5 (SGD with momentum, as in ``test_torch_train.py``: AdamW turns float
noise in a near-zero gradient into a step of ~lr); the loss and gradients
through ``FlashAttentionFn`` under remat at 1e-4 (``test_torch_whisper``'s
f32 tolerance); the inloop ``dW`` against the stacked workers' grads at
1e-5 relative to the leaf's largest entry (one f32 sum in another order);
``FlashAttentionFn``'s gradients against ``mha``'s at 1e-5 (the same
recompute).
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
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
from repro_torch.models import attention as TA
from repro_torch.models.attn_backend import FlashAttentionFn
from repro_torch.train.step import (loss_and_grads, make_train_step,
                                    stacked_grads)
from repro_torch.tree import at, paths

import repro_compose as RC
from repro_compose import close_tree, tparams

torch.set_num_threads(1)
# the module (the package re-exports its function under the same name)
TFA = importlib.import_module("repro_torch.kernels.flash_attention")

NAME = "whisper-medium"
REPO = Path(__file__).resolve().parent.parent
W = 4
BATCH, SEQ = 8, 24


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = j_get_arch(NAME).reduced(), t_get_arch(NAME).reduced()
    return jcfg, tcfg, JM.init(jax.random.PRNGKey(0), jcfg)


def _tbatch(cfg, step, batch=BATCH, seq=SEQ):
    return lm_batch(cfg, step, batch, seq, device="cpu")


# ---------------------------------------------------------------------------
# the stacked step against repro's mesh-free composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,method,attack,byz", [
    ("stacked-auto", "median", "signflip", 0.4),
    ("stacked-rrs", "trimmed_mean", "alie", 0.4),
    ("mean", "mean", "signflip", 0.4),
    ("stacked-auto", "median", "omniscient", 0.4),
])
def test_three_stacked_steps_match_repro(mode, method, attack, byz):
    """Three steps of the port's ``make_train_step`` (each worker's frames
    and tokens split off the global batch) against ``repro``'s stack,
    attack, aggregate and SGD update: the loss each step, then the params
    and the momentum."""
    jcfg, tcfg, jp = _models()
    beta = 0.25  # trims one of 4 rows a side
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
        jp, jo, jl = RC.step(jcfg, jp, jo, j_lm_batch(jcfg, i, BATCH, SEQ),
                             jest, attack, n_byz, jopt, mode, W)
        tp, to, tl = setup.step_fn(tp, to, _tbatch(tcfg, i))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-5)
    close_tree(jp, tp, 2e-5)
    close_tree(jo["m"], to["m"], 2e-5)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_stacked_grads_split_frames_per_worker():
    """Row w of each leaf's stack is worker w's own gradient: the loss and
    grads of its slice of the frames and tokens alone, bitwise."""
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 4)
    loss, stack = stacked_grads(tcfg, tp, b, W)
    per = BATCH // W
    losses = []
    for w in range(W):
        lw, gw = loss_and_grads(tcfg, tp, {k: v[w * per:(w + 1) * per]
                                           for k, v in b.items()})
        losses.append(lw)
        for path, s in paths(stack):
            assert torch.equal(s[w], at(gw, path)), path
    assert torch.equal(loss, torch.mean(torch.stack(losses)))


# ---------------------------------------------------------------------------
# the attention's backward: FlashAttentionFn, non-causal, S != T
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,chunk", [(7, 19, 4), (19, 7, 1024),
                                       (12, 12, 5), (24, 12, 1024)])
def test_flash_attention_fn_noncausal_grads_match_mha(S, T, chunk):
    """``FlashAttentionFn`` non-causal (B2's plain version on the CPU, the
    backward the chunked ``mha`` recomputed) over T keys of another
    length than its S queries, as whisper's cross attention runs it, with
    grouped heads: its output and q/k/v gradients are ``mha``'s."""
    rs = np.random.RandomState(S * 100 + T)
    q = torch.from_numpy(rs.randn(2, S, 4, 8).astype(np.float32))
    k = torch.from_numpy(rs.randn(2, T, 2, 8).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, T, 2, 8).astype(np.float32))
    dout = torch.from_numpy(rs.randn(2, S, 4, 8).astype(np.float32))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, False, chunk)
    got = torch.autograd.grad(out, (qa, ka, va), dout)
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = TA.mha(qb, kb, vb, causal=False, window=None, chunk=chunk)
    want = torch.autograd.grad(ref, (qb, kb, vb), dout)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_backend_under_remat_matches_repro(monkeypatch):
    """The whole model on the flash backend with ``cfg.remat``: every
    attention runs ``FlashAttentionFn`` (the encoder's and the cross
    attention's non-causal, the cross one over the encoder output), each
    layer of both stacks recomputed in the backward. The loss and every
    gradient (the encoder's through each decoder layer's cross k/v) match
    ``jax.value_and_grad(repro.models.model.loss)`` at 1e-4, and B2's
    forward runs twice an attention: the encoder's layers, a self and a
    cross a decoder layer."""
    jcfg, tcfg, jp = _models()
    tcfg = dataclasses.replace(tcfg, attn_backend="flash", remat=True)
    jb = j_lm_batch(jcfg, 2, 2, SEQ)
    jl, jg = jax.value_and_grad(lambda p: JM.loss(p, jcfg, jb))(jp)
    calls = []
    plain = TFA.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(TFA, "flash_attention", counted)
    tl, tg = loss_and_grads(tcfg, tparams(jp, tcfg), _tbatch(tcfg, 2, 2))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    close_tree(jg, tg, 1e-4)
    Le, L, Fr = tcfg.encoder.n_layers, tcfg.n_layers, tcfg.encoder.n_frames
    assert len(calls) == 2 * (Le + 2 * L)
    assert calls.count((Fr, Fr, False)) == 2 * Le
    assert calls.count((SEQ, Fr, False)) == 2 * L
    assert calls.count((SEQ, SEQ, True)) == 2 * L


# ---------------------------------------------------------------------------
# inloop: every product's dW aggregated over the workers in the backward
# ---------------------------------------------------------------------------

def _products(cfg, seq):
    """q, k, v, o and the MLP's three an encoder layer; the self
    attention's four, the cross attention's four and the MLP's three a
    decoder layer; the tied unembedding once a loss chunk."""
    return 7 * cfg.encoder.n_layers + 11 * cfg.n_layers + -(
        -seq // cfg.loss_chunk)


PRODUCT_LEAVES = ("enc_layers/attn/wq", "enc_layers/attn/wo",
                  "enc_layers/mlp/w_gate", "enc_layers/mlp/w_down",
                  "dec_layers/self/wq", "dec_layers/self/wv",
                  "dec_layers/cross/wq", "dec_layers/cross/wk",
                  "dec_layers/cross/wv", "dec_layers/cross/wo",
                  "dec_layers/mlp/w_up")
NORM_LEAVES = ("enc_layers/norm_attn", "dec_layers/norm_cross",
               "dec_layers/norm_ffn", "norm_enc", "norm_f")


def _leaf(tree, path):
    return at(tree, tuple(path.split("/")))


def test_inloop_weight_grads_carry_one_over_w():
    """Recorded and pinned (ROADMAP.md §C): with the mean, the in-backward
    dW of every product, the cross attention's k/v over the encoder
    output included, is the plain global dW / W, while a leaf outside the
    products (the norms) gets the full gradient."""
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 0)
    _, plain = loss_and_grads(tcfg, tp, b)
    with RR.robust_backward(W, "mean"):
        _, inloop = loss_and_grads(tcfg, tp, b)
    for leaf in PRODUCT_LEAVES:
        torch.testing.assert_close(_leaf(inloop, leaf) * W,
                                   _leaf(plain, leaf), rtol=1e-4, atol=1e-6,
                                   msg=leaf)
    for leaf in NORM_LEAVES:
        torch.testing.assert_close(_leaf(inloop, leaf), _leaf(plain, leaf),
                                   rtol=1e-4, atol=1e-6, msg=leaf)


def test_inloop_groups_every_product_by_worker():
    """Each worker's block of rows holds only its own data, so its partial
    dW of the global loss is 1/W of its own gradient: under the median
    (scale-equivariant) W x the inloop dW of every product, the cross k/v
    over the encoder's [B, F, D] rows included, is the median of the
    stacked workers' own grads."""
    _, tcfg, jp = _models()
    tp = tparams(jp, tcfg)
    b = _tbatch(tcfg, 1)
    _, stack = stacked_grads(tcfg, tp, b, W)
    with RR.robust_backward(W, "median"):
        _, inloop = loss_and_grads(tcfg, tp, b)
    for leaf in PRODUCT_LEAVES:
        # reprolint-torch: disable=RL001 oracle: the stack's median
        want = torch.quantile(_leaf(stack, leaf), 0.5, dim=0)
        got = _leaf(inloop, leaf) * W
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * float(want.abs().max()),
            msg=leaf)


@pytest.mark.parametrize("remat,seq", [(False, SEQ), (True, 40)])
def test_inloop_aggregates_each_product_once(monkeypatch, remat, seq):
    """One aggregate of a ``[W, D, F]`` dW stack per product and step,
    under remat too (the recompute runs the products' forward again, not
    their backward): 7 an encoder layer, 11 a decoder layer and the tied
    unembedding once a loss chunk (40 tokens: two chunks of 32)."""
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
    assert len(seen) == _products(tcfg, seq)
    assert all(len(s) == 3 and s[0] == W for s in seen)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stacked-auto", "inloop"])
def test_launcher_whisper_reduced_on_the_cpu(tmp_path, mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", NAME,
         "--reduced", "--device", "cpu", "--steps", "2", "--workers", "4",
         "--seq", "24", "--byzantine", "0.25", "--attack", "signflip",
         "--mode", mode, "--metrics", str(tmp_path / "m.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=whisper-medium-smoke ")
    assert "workers=4" in lines[0] and f"mode={mode}" in lines[0]
    steps = [ln.split() for ln in lines[1:3]]
    assert [s[:2] for s in steps] == [["step", "0"], ["step", "1"]]
    assert all(np.isfinite(float(s[3])) for s in steps)
    recs = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(recs) == 2
    # the diagnostics come from the materialized stack only
    assert ('"agg.alpha_hat"' in recs[-1]) == (mode != "inloop")
