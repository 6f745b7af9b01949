"""repro_torch's adaptive tier against ``repro``'s (DESIGN.md §14).

The CPU cases of ``tests/test_regimes.py``, JAX against the port on the
same stacks: each attacked stack is made once with JAX (its PRNG stream is
not torch's) and handed to both sides as numpy. Tolerances: the census's
masks, counts, weights, centre and ``alpha_hat`` exactly; ``z`` at 1e-5 of
the vector's scale (only the f32 summation order differs: the deviations
agree to ~1.5e-7 relative, and ``z = (dev - mom) / scale`` cancels near
zero); aggregates and the momentum at 1e-5. Within the port the honest bit
identities (``vrmom_adaptive`` = ``vrmom``, ``auto_gm`` =
``geometric_median`` on the same backend, ``alpha_hat`` = 0) and Krum's
selected row are exact.

``repro``'s ``make_train_step`` runs here on a one-device mesh (W = 1);
the census at W = 8 is held on ``repro``'s own stacked gradients, since
VRMOM jumps a count on 1e-7 input differences.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get as j_get_arch
from repro.core import adaptive as JAD
# reprolint: disable=RL001 oracle: the port's aggregators are held against repro's below the Estimator layer
from repro.core import aggregators as JAG  # reprolint-torch: disable=RL001 oracle
from repro.core import attacks as JA
from repro.core.estimator import Estimator as JE
from repro.data import lm_batch as j_lm_batch
from repro.dist import robust_reduce as JRR
from repro.models import model as JM
from repro.obs import diag as JD
from repro_torch import optim as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import adaptive_state_from_jax, params_from_jax
from repro_torch.core import adaptive as AD
# reprolint: disable=RL001 oracle: the port's whole-vector aggregators and pairwise distances are held below the Estimator layer
from repro_torch.core import aggregators as AG  # reprolint-torch: disable=RL001 oracle
from repro_torch.core.estimator import METHODS, Estimator
from repro_torch.data import lm_batch
from repro_torch.dist import robust_reduce as RR
from repro_torch.obs import diag as TD
from repro_torch.train.step import make_train_step, stacked_grads
from repro_torch.tree import leaves as _leaves

torch.set_num_threads(1)

ATTACKS = ("gaussian", "signflip", "wrong_value", "alie", "ipm", "mimic")
W, C, MU = 41, 40, 2.0
BACKENDS = ("torch", "auto")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _stack(key=0, shape=(W, C)):
    return np.array(jax.random.normal(jax.random.PRNGKey(key), shape) + MU)


def _attacked(attack, alpha, key=0, shape=(W, C)):
    v = jnp.asarray(_stack(key, shape))
    mask = JA.byzantine_mask(shape[0], alpha)
    out = JA.REGISTRY[attack](jax.random.PRNGKey(100 + key), v, mask)
    return np.array(out), np.asarray(mask)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_z(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alpha", (0.2, 0.25))
@pytest.mark.parametrize("attack", ATTACKS)
def test_census_matches_repro(attack, alpha, backend):
    va, mask = _attacked(attack, alpha)
    want = JAD.census(jnp.asarray(va))
    got = AD.census(_t(va), backend=backend)
    _close_z(got.z, want.z)
    for f in ("cluster_size", "suspected", "alpha_hat", "weights", "center"):
        _same(getattr(got, f), getattr(want, f))
    assert got.cluster_size.dtype == torch.int32
    _same(AD.estimate_alpha(_t(va), backend=backend),
          JAD.estimate_alpha(jnp.asarray(va)))
    _same(AD.worker_weights(_t(va), backend=backend),
          JAD.worker_weights(jnp.asarray(va)))
    # the regimes' own claim: alpha_hat lands near the truth
    assert abs(float(got.alpha_hat) - mask.mean()) <= 0.1


@pytest.mark.parametrize("backend", BACKENDS)
def test_estimate_alpha_honest_is_exactly_zero(backend):
    for key in range(4):
        v = _t(_stack(key))
        assert float(AD.estimate_alpha(v, backend=backend)) == 0.0
        assert torch.all(AD.worker_weights(v, backend=backend) == 1.0)
        assert not bool(AD.census(v, backend=backend).suspected.any())


def test_census_constants_match_obs_diag():
    assert AD.Z_THRESH == TD._Z_THRESH == JD._Z_THRESH == JAD.Z_THRESH
    assert AD.REL_FLOOR == TD._REL_FLOOR == JD._REL_FLOOR == JAD.REL_FLOOR
    assert AD.SUSPECT_WEIGHT == JAD.SUSPECT_WEIGHT
    assert AD.LOUD_RATIO == JAD.LOUD_RATIO
    assert AD.K_LADDER_THRESHOLDS == JAD.K_LADDER_THRESHOLDS
    assert AD.DUP_REL_TOL == JAD.DUP_REL_TOL


def test_duplicates_found_by_direct_differences():
    """Copies of one payload have squared distance exactly 0.0, large rows
    included: the Gram form |a|^2 + |b|^2 - 2 a.b leaves ~1e-7 relative
    there, far above DUP_REL_TOL times the median distance."""
    v = _stack(5, (8, 4096)) * 1e3
    v[6] = v[7] = v[0] * 1.0001
    # reprolint-torch: disable=RL001 unit under test: the distances
    d2 = AG.pairwise_sq(_t(v)[None])[0]
    assert float(d2[6, 7]) == 0.0 and float(d2[7, 6]) == 0.0
    x = _t(v).double()
    sq = (x * x).sum(-1)
    gram = (sq[:, None] + sq[None] - 2 * x @ x.T).float()
    assert float(gram[6, 7]) != 0.0
    cen = AD.census(_t(v))
    _same(cen.cluster_size, [1, 1, 1, 1, 1, 1, 2, 2])
    _same(cen.suspected, [False] * 6 + [True] * 2)


# ---------------------------------------------------------------------------
# the K ladder
# ---------------------------------------------------------------------------

def test_k_ladder_and_select_k():
    for K in (1, 2, 3, 8, 10, 65):
        assert AD.k_ladder(K) == JAD.k_ladder(K)
    assert AD.k_ladder(10) == (10, 5, 1) and AD.k_ladder(1) == (1,)
    f32 = np.float32
    alphas = np.array([0.0, 0.01, 0.02, np.nextafter(f32(0.02), f32(1)),
                       0.1, 0.2, np.nextafter(f32(0.2), f32(1)), 0.3,
                       0.499], dtype=np.float32)
    for K in (10, 8, 3, 1):
        got = AD.select_k(_t(alphas), K)
        want = [float(JAD.select_k(jnp.float32(a), K)) for a in alphas]
        _same(got, np.asarray(want, np.float32))
    got = AD.select_k(_t(alphas), 10).tolist()
    assert got[2] == 10.0 and got[5] == 5.0 and got[6] == 1.0


@pytest.mark.parametrize("n", (5, 10))
def test_ladder_takes_k_half_at_alpha_exactly_0_2(n):
    """alpha_hat = f32(1/5) = f32(2/10) = f32(0.2) compares equal to the
    f32 threshold: the K//2 rung runs on the imputed stack."""
    v = _stack(7, (n, 64))
    if n == 5:
        v[4] += 100.0      # one loud row
    else:
        v[8] = v[9] = 0.5  # one duplicate payload
    cen = AD.census(_t(v))
    assert cen.alpha_hat.item() == np.float32(0.2)
    assert float(JAD.census(jnp.asarray(v)).alpha_hat) == np.float32(0.2)
    assert float(AD.select_k(cen.alpha_hat, 10)) == 5.0
    x_adj = torch.where(cen.suspected[:, None], cen.center[None], _t(v))
    for backend in BACKENDS:
        got = Estimator("vrmom_adaptive", K=10, backend=backend).apply(_t(v))
        _same(got, Estimator("vrmom", K=5, backend=backend).apply(x_adj))
    _close(AD.vrmom_adaptive(_t(v), K=10),
           JAD.vrmom_adaptive(jnp.asarray(v), K=10))


# ---------------------------------------------------------------------------
# the honest bit identities and the aggregates against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_vrmom_adaptive_honest_bit_identical_to_vrmom(backend):
    for key in (4, 5):
        v = _t(_stack(key))
        want = Estimator("vrmom", K=10, backend=backend).apply(v)
        _same(Estimator("vrmom_adaptive", K=10, backend=backend).apply(v),
              want)
        _same(AD.vrmom_adaptive(v, K=10, backend=backend), want)
    _close(AD.vrmom_adaptive(v, K=10),
           JAD.vrmom_adaptive(jnp.asarray(v.numpy()), K=10))


@pytest.mark.parametrize("backend", BACKENDS)
def test_auto_gm_honest_bit_identical_to_geometric_median(backend):
    v = _t(_stack(3))
    # reprolint-torch: disable=RL001 oracle: auto_gm's honest fixed point
    want = AG.geometric_median(v)
    _same(AD.auto_gm(v, backend=backend), want)
    _same(Estimator("auto_gm", backend=backend).apply(v), want)
    _same(Estimator("geometric_median").apply(v), want)
    _close(want, JAG.geometric_median(jnp.asarray(v.numpy())))


@pytest.mark.parametrize("attack", ATTACKS)
def test_adaptive_aggregates_match_repro(attack):
    va, _ = _attacked(attack, 0.2)
    for method in ("vrmom_adaptive", "auto_gm", "geometric_median"):
        want = np.asarray(JE(method).apply(jnp.asarray(va), axis=0))
        for backend in BACKENDS:
            if method == "geometric_median" and backend == "auto":
                continue
            got = Estimator(method, backend=backend).apply(_t(va), axis=0)
            _close(got, want)


@pytest.mark.parametrize("attack", ("signflip", "ipm", "wrong_value"))
def test_adaptive_beats_fixed_k(attack):
    """test_regimes' contrast on the port: at alpha 0.2 both adaptive arms
    land strictly nearer the truth than fixed-K VRMOM."""
    va, _ = _attacked(attack, 0.2)

    def err(method):
        agg = Estimator(method, K=10).apply(_t(va))
        return float(torch.linalg.norm(agg - MU))

    for method in ("vrmom_adaptive", "auto_gm"):
        assert err(method) < err("vrmom"), (attack, method)


# ---------------------------------------------------------------------------
# the stateful carry
# ---------------------------------------------------------------------------

def _jstate_np(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("momentum", (0.0, 0.9))
@pytest.mark.parametrize("method", ("auto_gm", "vrmom_adaptive"))
def test_apply_adaptive_three_steps_match_repro(method, momentum):
    """Three stateful steps over stacks under different attacks, from a
    state repro has already moved (carried in by
    ``convert.adaptive_state_from_jax``)."""
    jest, test = JE(method, K=10), Estimator(method, K=10)
    js = jest.init_adaptive_state(W, C)
    _, js = jest.apply_adaptive(jnp.asarray(_attacked("gaussian", 0.2, 9)[0]),
                                js, momentum=momentum)
    ts = adaptive_state_from_jax(_jstate_np(js), device="cpu")
    for k, attack in enumerate(("ipm", "signflip", "alie")):
        va, _ = _attacked(attack, 0.2, key=10 + k)
        jo, js = jest.apply_adaptive(jnp.asarray(va), js, momentum=momentum)
        to, ts = test.apply_adaptive(_t(va), ts, momentum=momentum)
        _close(to, jo)
        _close(ts.momentum, js.momentum)
        _same(ts.weights, js.weights)
        _same(ts.alpha_hat, js.alpha_hat)
        assert int(ts.step) == int(js.step) == k + 2
        assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("method", ("auto_gm", "vrmom_adaptive"))
def test_stateful_honest_bit_identical_and_state_fixed(method):
    est = Estimator(method)
    state = est.init_adaptive_state(W, C, device="cpu")
    for k in range(3):
        v = _t(_stack(10 + k))
        out, state = est.apply_adaptive(v, state)
        _same(out, est.apply(v))
        assert torch.all(state.weights == 1.0)
        assert float(state.alpha_hat) == 0.0 and int(state.step) == k + 1


def test_adaptive_state_from_jax_checks_its_input():
    js = _jstate_np(JE("auto_gm").init_adaptive_state(4, 6))
    ts = adaptive_state_from_jax(js, device="cpu")
    assert ts.weights.shape == (4,) and ts.momentum.shape == (6,)
    with pytest.raises(TypeError, match="step"):
        adaptive_state_from_jax(js._replace(step=np.int64(0)), device="cpu")
    with pytest.raises(ValueError, match="weights"):
        adaptive_state_from_jax(js._replace(weights=np.ones((2, 2),
                                                            np.float32)),
                                device="cpu")
    with pytest.raises(ValueError, match="carries no adaptive state"):
        Estimator("vrmom").init_adaptive_state(4, 6, device="cpu")


# ---------------------------------------------------------------------------
# the Estimator: every method, the batched apply, the serving tail
# ---------------------------------------------------------------------------

def test_every_method_applies_and_validates():
    x = _t(_stack(2, (8, 3, 5)))
    for method in METHODS:
        est = Estimator(method, beta=0.25)
        out = est.apply(x, axis=0)
        assert out.shape == (3, 5) and torch.isfinite(out).all(), method
    for method in ("geometric_median", "krum", "auto_gm", "vrmom_adaptive"):
        for backend in ("auto", "torch", "cuda"):
            assert Estimator(method, backend=backend).resolve_backend() \
                == "torch"
        with pytest.raises(ValueError, match="whole-vector"):
            Estimator(method, backend="ref").validate(8)
    for method in ("geometric_median", "krum"):
        with pytest.raises(ValueError, match="whole-vector"):
            Estimator(method, backend="cuda").validate(8)
    Estimator("auto_gm", backend="cuda").validate(8)
    with pytest.raises(ValueError, match="K >= 1"):
        Estimator("vrmom_adaptive", K=0).validate(8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ("vrmom_adaptive", "auto_gm",
                                    "geometric_median", "krum"))
def test_batched_apply_equals_per_replication_calls(method, backend):
    """Dims before the worker axis are independent batches: one census
    each, as repro's map over replications gives; the coverage harness
    hands [R, m+1, p] stacks to apply(axis=1)."""
    if method in ("geometric_median", "krum") and backend == "auto":
        backend = "torch"
    reps = [_attacked(a, 0.2, key=20 + i, shape=(11, 3, 2))[0]
            for i, a in enumerate(("ipm", "gaussian",
                                   "signflip"))]
    reps.append(_stack(30, (11, 3, 2)))
    x = _t(np.stack(reps))                              # [4, 11, 3, 2]
    est = Estimator(method, backend=backend, n_byzantine=2)
    got = est.apply(x, axis=1)
    assert got.shape == (4, 3, 2)
    want = torch.stack([est.apply(x[r], axis=0) for r in range(4)])
    _same(got, want)
    # two batch dims, the worker axis third from the end
    got2 = est.apply(x.reshape(2, 2, 11, 3, 2), axis=2)
    _same(got2.reshape(4, 3, 2), want)


@pytest.mark.parametrize("method", ("vrmom_adaptive", "auto_gm"))
def test_apply_sample_runs_one_census_over_the_replica_stack(method):
    """[m, B, V] logits: one census over the [m, B·V] rows, the aggregate
    then argmax / top-k in PyTorch, as repro."""
    m, B, V = 8, 3, 16
    x = _stack(40, (m, B, V)).astype(np.float32)
    x[6] = x[7] = -5.0  # one duplicate payload on two replicas
    est = Estimator(method, K=8)
    agg, tok = est.apply_sample(_t(x))
    want = est.apply(_t(x).reshape(m, -1)).reshape(B, V)
    _same(agg, want)
    _same(tok, torch.argmax(want, -1).to(torch.int32))
    _, topv, topi = est.apply_sample(_t(x), top_k=4)
    _same(topi[:, 0], tok)
    jagg = JE(method, K=8).apply(jnp.asarray(x), axis=0)
    _close(agg, jagg)


@pytest.mark.parametrize("method", ("vrmom_adaptive", "auto_gm", "vrmom",
                                    "median"))
def test_serve_token_identity_under_attack(method):
    """m = 8 replicas at alpha 0.25 under the gaussian attack: the adaptive
    arms serve the honest greedy tokens (repro's test_regimes case), the
    mean control does not."""
    from repro_torch.serve import RobustDecodeConfig, Sampling
    from repro_torch.serve.robust import robust_sample

    B, V, m = 4, 64, 8
    honest = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(21),
                                             (B, V))))
    logits_r = honest[None].expand(m, B, V)
    want = torch.argmax(honest, -1).to(torch.int32)
    sc = Sampling(method="greedy")
    for fuse in (True, False):
        rcfg = RobustDecodeConfig(m=m, estimator=method, K=8,
                                  attack="gaussian", alpha=0.25,
                                  fuse_tail=fuse)
        tok = robust_sample(logits_r, rcfg, torch.Generator().manual_seed(5),
                            sc)
        _same(tok, want)
    mcfg = RobustDecodeConfig(m=m, estimator="mean", attack="gaussian",
                              alpha=0.25)
    tok = robust_sample(logits_r, mcfg, torch.Generator().manual_seed(5), sc)
    assert bool((tok != want).any()), "control not corrupted"


@pytest.mark.parametrize("method", ("vrmom_adaptive", "auto_gm"))
def test_engine_serves_clean_tokens_with_an_adaptive_tail(method):
    """ServeEngine.generate on the reduced qwen3 with an adaptive robust
    tail: the greedy tokens equal the plain engine's under none,
    signflip and gaussian, shared and replicated."""
    from repro_torch.models import model as TM
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    cfg = t_get_arch("qwen3-1.7b").reduced()
    params = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                     generator=torch.Generator().manual_seed(1))}
    want = ServeEngine(cfg, params, max_len=16, device="cpu").generate(
        batch, 5)
    for attack in ("none", "signflip", "gaussian"):
        for share in (True, False):
            rcfg = RobustDecodeConfig(m=4, estimator=Estimator(method, K=8),
                                      attack=attack, alpha=0.25,
                                      share_replica_compute=share)
            eng = ServeEngine(cfg, params, max_len=16, robust=rcfg,
                              device="cpu")
            got = eng.generate(batch, 5,
                               generator=torch.Generator().manual_seed(3))
            _same(got, want)


# ---------------------------------------------------------------------------
# the paper path: inference and coverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator,attack", [
    ("vrmom_adaptive", "ipm"), ("auto_gm", "alie"), ("auto_gm", "none"),
    ("vrmom_adaptive", "signflip")])
def test_infer_with_an_adaptive_estimator_matches_repro(estimator, attack):
    from repro.core import rcsl as JR
    from repro.infer import sandwich as JS
    from repro_torch.core import rcsl as TR
    from repro_torch.infer import sandwich as TS

    rng = np.random.RandomState(3)
    p = 4
    theta = np.linspace(1, 0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(21, 120, p).astype(np.float32)
    Y = (X @ theta + rng.randn(21, 120)).astype(np.float32)
    th = (theta + 0.02 * rng.randn(p)).astype(np.float32)
    kw = dict(estimator=estimator, K=8, level=0.9,
              alpha=0.0 if attack == "none" else 0.2, attack=attack,
              assumed_alpha=0.0)
    want = JS.infer(JR.LinearRegressionProblem(),
                    JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                    jnp.asarray(th), key=jax.random.PRNGKey(0), **kw)
    got = TS.infer(TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)),
                   _t(th), generator=torch.Generator(), **kw)
    rtol = 1e-3 if estimator == "auto_gm" else 1e-5  # MOM's factor, §C
    for name in ("H", "Sigma"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for name in ("lower", "upper"):
        np.testing.assert_allclose(getattr(got.ci, name).numpy(),
                                   np.asarray(getattr(want.ci, name)),
                                   rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("estimator", ("auto_gm", "vrmom_adaptive"))
def test_coverage_wire_accepts_adaptive_estimator(estimator):
    from repro_torch.infer import coverage_run

    cell = coverage_run(model="linear", attack="alie", alpha=0.2,
                        estimator=estimator, reps=8, N_per_machine=100,
                        m_workers=20, p=3, rounds=3, batch_size=4, seed=7,
                        device="cpu")
    s = cell.summary()
    assert np.isfinite(s["rmse"]) and s["reps"] == 8
    assert s["coverage"] >= 0.5, s


def test_coverage_assumed_alpha_narrows_ci():
    from repro_torch.infer import coverage_run

    kw = dict(model="linear", attack="alie", alpha=0.2,
              estimator="vrmom_adaptive", K=5, reps=8, N_per_machine=100,
              m_workers=20, p=3, rounds=3, batch_size=4, seed=7,
              device="cpu")
    w_naive = float(coverage_run(assumed_alpha=0.0, **kw).width.mean())
    w_oracle = float(coverage_run(assumed_alpha=0.2, **kw).width.mean())
    assert w_naive < w_oracle, (w_naive, w_oracle)


# ---------------------------------------------------------------------------
# the training wire
# ---------------------------------------------------------------------------

def _grads(attack="none", n_byz=2):
    g = {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 4, 6)) + 1.0,
         "b": jax.random.normal(jax.random.PRNGKey(1), (8, 5)) + 1.0,
         "n": {"s": jax.random.normal(jax.random.PRNGKey(2), (8, 3, 3))}}
    if attack != "none":
        mask = jnp.arange(8) >= 8 - n_byz
        g = jax.tree.map(lambda x: JA.REGISTRY[attack](
            jax.random.PRNGKey(3), x, mask), g)
    return g, jax.tree.map(lambda x: _t(np.asarray(x)), g)


def _close_tree(jtree, ttree, tol=1e-5):
    jl, tl = jax.tree.leaves(jtree), list(_leaves(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, tol)


@pytest.mark.parametrize("chunk", (None, 7))
@pytest.mark.parametrize("method", ("auto_gm", "vrmom_adaptive"))
def test_stacked_adaptive_wire_honest_matches_stateless(method, chunk,
                                                        monkeypatch):
    if chunk:
        monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
    jg, g = _grads()
    est = Estimator(method)
    dim = sum(x[0].numel() for x in _leaves(g))
    out, state = RR.aggregate_stacked_adaptive(
        g, est.init_adaptive_state(8, dim, device="cpu"), est)
    direct = RR.aggregate_stacked_auto(g, est)
    for a, b in zip(_leaves(out), _leaves(direct)):
        _same(a, b)
    assert torch.all(state.weights == 1.0) and float(state.alpha_hat) == 0.0
    _close_tree(JRR.aggregate_stacked_auto(jg, JE(method)), out)


@pytest.mark.parametrize("momentum", (0.0, 0.9))
@pytest.mark.parametrize("attack", ("ipm", "gaussian", "signflip"))
@pytest.mark.parametrize("method", ("auto_gm", "vrmom_adaptive"))
def test_stacked_adaptive_wire_matches_repro(method, attack, momentum,
                                             monkeypatch):
    """Column blocks of 7 (every leaf cut, blocks across no leaf edge):
    the same function as repro's raveled f32 wire."""
    monkeypatch.setattr(RR, "WIRE_CHUNK", 7)
    jg, g = _grads(attack)
    jest, est = JE(method), Estimator(method)
    dim = sum(x[0].numel() for x in _leaves(g))
    js = jest.init_adaptive_state(8, dim)
    ts = est.init_adaptive_state(8, dim, device="cpu")
    for _ in range(2):
        jo, js = JRR.aggregate_stacked_adaptive(jg, js, jest,
                                                momentum=momentum)
        to, ts = RR.aggregate_stacked_adaptive(g, ts, est, momentum=momentum)
        _close_tree(jo, to)
        _close(ts.momentum, js.momentum)
        _same(ts.weights, js.weights)
        _same(ts.alpha_hat, js.alpha_hat)
    _close_tree(JRR.aggregate_stacked_auto(jg, jest),
                RR.aggregate_stacked_auto(g, est))
    assert float(ts.weights.min()) < 1.0


def test_wire_census_equals_the_flat_census(monkeypatch):
    """The block-by-block census of a tree equals the census of its
    raveled [W, C] wire: masks, counts, weights and alpha_hat exactly,
    z at 1e-5 (summation order)."""
    _, g = _grads("ipm")
    wire = torch.cat([x.reshape(8, -1) for x in _leaves(g)], dim=1)
    want = AD.census(wire)
    for chunk in (3, 7, 1 << 22):
        monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
        got = RR._wire_census(list(_leaves(g)), False)
        _close_z(got.z, want.z)
        for f in ("cluster_size", "suspected", "alpha_hat", "weights"):
            _same(getattr(got, f), getattr(want, f))
    _same(want.suspected, [False] * 6 + [True] * 2)


@pytest.mark.parametrize("chunk", (5, 1 << 22))
def test_weiszfeld_stacked_equals_the_flat_weiszfeld(chunk, monkeypatch):
    monkeypatch.setattr(RR, "WIRE_CHUNK", chunk)
    _, g = _grads("gaussian")
    wire = torch.cat([x.reshape(8, -1) for x in _leaves(g)], dim=1)
    pi = torch.linspace(0.5, 1.0, 8)
    # reprolint-torch: disable=RL001 oracle: the blockwise wire's plain iterate
    _close(RR.weiszfeld_stacked(g, pi), AG.weiszfeld(wire, pi), 1e-6)


def test_wire_refusals():
    _, g = _grads()
    with pytest.raises(ValueError, match="needs an adaptive estimator"):
        RR.aggregate_stacked_adaptive(g, None, "vrmom")
    with pytest.raises(ValueError, match="whole-vector"):
        RR.aggregate_stacked_auto(g, "krum")
    with pytest.raises(ValueError, match="whole-vector"):
        RR.aggregate(g, mode="stacked-rrs", est="auto_gm")
    with pytest.raises(ValueError, match="whole-vector"):
        RR.aggregate_stacked_auto(g, "auto_gm", reduce_backend="consensus")
    with pytest.raises(ValueError, match="whole-vector"):
        with RR.robust_backward(4, "vrmom_adaptive"):
            pass


@pytest.mark.parametrize("method", ("auto_gm", "vrmom_adaptive"))
def test_vrmom_adaptive_on_repro_stack(method):
    """The census and aggregate of repro's own per-worker gradients of the
    reduced qwen3 (W = 8, one sequence a worker), two rows under ipm: the
    census marks exactly those rows in both packages."""
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    jb = j_lm_batch(jcfg, 0, 8, 24)
    vg = jax.vmap(jax.value_and_grad(lambda p, b: JM.loss(p, jcfg, b)),
                  in_axes=(None, 0))
    bw = jax.tree.map(lambda x: x.reshape((8, -1) + x.shape[1:]), jb)
    _, jg = jax.jit(vg)(jp, bw)
    mask = jnp.arange(8) >= 6
    jg = jax.tree.map(lambda x: JA.get("ipm")(None, x, mask), jg)
    tg = jax.tree.map(lambda x: _t(np.asarray(x)), jg)
    dim = sum(x[0].size for x in jax.tree.leaves(jg))
    jest = JE(method)
    jo, js = JRR.aggregate_stacked_adaptive(
        jg, jest.init_adaptive_state(8, dim), jest)
    to, ts = RR.aggregate_stacked_adaptive(
        tg, Estimator(method).init_adaptive_state(8, dim, device="cpu"),
        Estimator(method))
    _close_tree(jo, to)
    _close(ts.momentum, js.momentum)
    _same(ts.weights, js.weights)
    _same(ts.weights, [1.0] * 6 + [0.75] * 2)
    assert float(ts.alpha_hat) == float(js.alpha_hat) == 0.125


def test_auto_gm_train_step_matches_repro_one_device_mesh():
    """repro's make_train_step (auto_gm, one-device mesh: W = 1) and the
    port's, from the same params, SGD with momentum: the loss, the params
    and the carried state over three steps."""
    from repro.train.step import make_train_step as j_make_train_step

    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jopt = JO.get("sgd", lr=0.5, momentum=0.9)
    topt = TO.get("sgd", lr=0.5, momentum=0.9)
    jset = j_make_train_step(jcfg, mesh, estimator="auto_gm",
                             optimizer=jopt, momentum=0.5)
    tset = make_train_step(tcfg, 1, estimator="auto_gm", optimizer=topt,
                           momentum=0.5, device="cpu")
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jo, to = jopt.init(jp), topt.init(tp)
    js, ts = jset.init_state(), tset.init_state()
    assert ts.momentum.shape == js.momentum.shape
    jstep = jax.jit(jset.step_fn)
    for i in range(3):
        jp, jo, jl, js = jstep(jp, jo, j_lm_batch(jcfg, i, 2, 16),
                               jax.random.PRNGKey(i), js)
        tp, to, tl, ts = tset.step_fn(tp, to, lm_batch(tcfg, i, 2, 16,
                                                       device="cpu"),
                                      None, ts)
        _close(float(tl), float(jl))
    _close_tree(jp, tp, 2e-5)
    _close(ts.momentum, js.momentum, 2e-5)
    _same(ts.weights, js.weights)
    assert int(ts.step) == int(js.step) == 3


def test_stacked_adaptive_step_carries_the_state():
    """The port's stacked-adaptive step at W = 8 (reduced qwen3): honest,
    the aggregate is fixed VRMOM's bit for bit and the state stays at the
    unit fixed point; under ipm on int(0.4 * 7) = 2 rows the census marks
    rows 6 and 7 (one payload), the state's alpha_hat is the EMA
    (1 - 0.5^s) * 0.25, those rows' weights follow the EMA toward 1/2, the
    honest rows keep 1.0, and the loss stays finite and stable."""
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), j_get_arch("qwen3-1.7b").reduced())

    def fresh():
        return params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")

    batch = lm_batch(tcfg, 0, 8, 16, device="cpu")
    fixed = make_train_step(tcfg, 8, estimator="vrmom", mode="stacked-auto",
                            optimizer=TO.get("sgd", lr=0.1), device="cpu")
    adapt = make_train_step(tcfg, 8, estimator="vrmom_adaptive",
                            optimizer=TO.get("sgd", lr=0.1), device="cpu")
    p1, p2 = fresh(), fresh()
    p1, _, _ = fixed.step_fn(p1, fixed.optimizer.init(p1), batch)
    st = adapt.init_state()
    p2, _, _, st = adapt.step_fn(p2, adapt.optimizer.init(p2), batch, None,
                                 st)
    for a, b in zip(_leaves(p1), _leaves(p2)):
        _same(a, b)
    assert torch.all(st.weights == 1.0) and float(st.alpha_hat) == 0.0

    for method in ("vrmom_adaptive", "auto_gm"):
        setup = make_train_step(tcfg, 8, estimator=method,
                                byzantine_frac=0.4, attack="ipm", lr=1e-3,
                                with_diag=True, device="cpu")
        p = fresh()
        o = setup.optimizer.init(p)
        st = setup.init_state()
        losses = []
        for s in range(1, 4):
            p, o, loss, st, diag = setup.step_fn(
                p, o, lm_batch(tcfg, s, 8, 16, device="cpu"), None, st)
            losses.append(float(loss))
            want_a = np.float32((1 - 0.5 ** s) * 0.25)
            np.testing.assert_array_max_ulp(st.alpha_hat.numpy(), want_a, 1)
            w_byz = np.float32(0.5 ** s + (1 - 0.5 ** s) * 0.5)
            np.testing.assert_array_max_ulp(st.weights[6:].numpy(),
                                            np.full(2, w_byz), 1)
            assert torch.all(st.weights[:6] == 1.0)
            assert int(st.step) == s
        assert np.isfinite(losses).all() and losses[-1] < losses[0] + 0.5
        assert diag.scores.shape == (8,)


def test_krum_reference_fault_pinned():
    """repro's krum adds eye * inf to exclude self; 0 * inf is NaN, every
    score is NaN and argmin returns row 0 whatever the stack. The port
    masks the diagonal and picks the row a numpy Krum oracle picks."""
    v = _stack(50, (7, 6)).astype(np.float32)
    v[0] += 100.0
    assert np.array_equal(np.asarray(JAG.krum(jnp.asarray(v))), v[0])

    def oracle(x, f):
        m = x.shape[0]
        d2 = ((x[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = max(m - f - 2, 1)
        return x[int(np.argmin(np.sort(d2, axis=1)[:, :k].sum(1)))]

    # reprolint-torch: disable=RL001 unit under test: Krum below the Estimator
    got = AG.krum(_t(v))
    _same(got, oracle(v, 0))
    assert not np.array_equal(got.numpy(), v[0])
    for seed, f in ((51, 0), (52, 2), (53, 3)):
        x = _attacked("gaussian", 0.25, seed, (9, 5))[0]
        _same(Estimator("krum", n_byzantine=f).apply(_t(x)), oracle(x, f))


@pytest.mark.parametrize("attack", ("alie", "ipm", "mimic"))
def test_attack_moments_in_column_blocks_are_exact(attack, monkeypatch):
    """The omniscient attacks' honest moments run in column blocks (a
    full-width gradient leaf would otherwise take several f32 copies of
    itself): the attacked stack is the same bits at any block size, and
    repro's at 1e-6."""
    from repro_torch.core import attacks as TA

    v = _stack(60, (8, 5, 7)).astype(np.float32)
    mask = torch.arange(8) >= 6
    want = TA.get(attack)(None, _t(v), mask)
    monkeypatch.setattr(TA, "_MOMENT_BLOCK", 4)
    got = TA.get(attack)(None, _t(v), mask)
    _same(got, want)
    jwant = JA.get(attack)(None, jnp.asarray(v), jnp.asarray(mask.numpy()))
    _close(got, jwant, 1e-6)
