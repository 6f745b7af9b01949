"""repro_torch's inference layer (plug-in sandwich CIs, coverage harness)
against ``repro.infer``.

The same numpy inputs go through both packages on the CPU. Tolerances:
1e-6 for ``bvn_cdf`` (f32 with the same 24 nodes), 1e-5 relative for the
covariance factors and for ``infer``'s H, Sigma, Xi and CIs (f32 sums in
another order); the host quadrature oracle at 2e-3, as in
``tests/test_infer.py``. The coverage cell is a statistical contract: the
torch and JAX PRNG streams differ.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcsl as JR
from repro.core import vrmom as JV
from repro.core.estimator import Estimator as JEst
from repro.dist.robust_reduce import \
    aggregate_symmetric_stacked as j_symmetric
from repro.infer import sandwich as JS
from repro_torch.core import rcsl as TR
from repro_torch.core import vrmom as TV
from repro_torch.core.estimator import Estimator
from repro_torch.dist import aggregate_symmetric_stacked
from repro_torch.infer import coverage_run
from repro_torch.infer import sandwich as TS

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _spd(seed, p=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, p))
    return (A @ A.T + 0.5 * np.eye(p)).astype(np.float32)


# ---------------------------------------------------------------------------
# The Theorem-4 machinery
# ---------------------------------------------------------------------------

def test_bvn_cdf_matches_repro():
    rng = np.random.RandomState(0)
    a = rng.randn(200).astype(np.float32) * 1.5
    b = rng.randn(200).astype(np.float32) * 1.5
    rho = np.clip(rng.randn(200) * 0.6, -1, 1).astype(np.float32)
    rho[:4] = [1.0, -1.0, 1 - 1e-7, -1 + 1e-7]
    _close(TS.bvn_cdf(_t(a), _t(b), _t(rho)), JS.bvn_cdf(a, b, rho), rtol=0,
           atol=1e-6)
    for a_, b_, r_ in [(0.5, -0.3, 0.6), (0.0, 0.0, 0.3), (1.2, 1.2, -0.8)]:
        assert float(TS.bvn_cdf(a_, b_, r_)) == pytest.approx(
            TV._phi2_cdf_grid(a_, b_, r_), abs=2e-4)


def test_bvn_cdf_special_values():
    from scipy.special import ndtr

    assert float(TS.bvn_cdf(0.7, -0.2, 0.0)) == pytest.approx(
        ndtr(0.7) * ndtr(-0.2), abs=1e-6)
    rho = 0.37  # the arcsine law at the origin
    assert float(TS.bvn_cdf(0.0, 0.0, rho)) == pytest.approx(
        0.25 + math.asin(rho) / (2 * math.pi), abs=1e-6)
    assert float(TS.bvn_cdf(0.7, 1.5, 1.0)) == pytest.approx(ndtr(0.7),
                                                             abs=1e-6)
    assert float(TS.bvn_cdf(0.5, -0.5, -1.0)) == pytest.approx(
        ndtr(0.5) + ndtr(-0.5) - 1.0, abs=1e-6)
    assert float(TS.bvn_cdf(-3.0, 0.2, -1.0)) == 0.0


@pytest.mark.parametrize("K", [1, 4, 10])
def test_vrmom_cov_factor_matches_repro_and_oracle(K):
    Sigma = _spd(0)
    got = TS.vrmom_cov_factor(_t(Sigma), K=K)
    _close(got, JS.vrmom_cov_factor(jnp.asarray(Sigma), K=K))
    assert torch.equal(got, got.T)  # mirrored: exactly symmetric
    if K == 10:
        _close(got, TV.vrmom_asymptotic_cov(Sigma, K=10), rtol=2e-3,
               atol=1e-4)
        _close(torch.diagonal(got), TV.sigma_k_sq(10) * np.diag(Sigma),
               rtol=1e-4)
    # leading replication axes: each slice is the one-matrix call
    S2 = np.stack([Sigma, _spd(1)])
    batched = TS.vrmom_cov_factor(_t(S2), K=K)
    _close(batched[1], TS.vrmom_cov_factor(_t(S2[1]), K=K), rtol=0, atol=0)


def test_mom_cov_factor_and_dispatch():
    Sigma = _spd(1)
    got = TS.mom_cov_factor(_t(Sigma))
    _close(got, JS.mom_cov_factor(jnp.asarray(Sigma)))
    _close(got, TV.mom_asymptotic_cov(Sigma), rtol=2e-3, atol=1e-4)
    _close(torch.diagonal(got), (math.pi / 2) * np.diag(Sigma))
    S = _t(Sigma)
    for method, kw in (("vrmom", {}), ("median", {}), ("mom", {}),
                       ("mean", {}), ("trimmed_mean", dict(beta=0.2)),
                       ("vrmom_adaptive", {}), ("auto_gm", {})):
        _close(TS.cov_factor(S, Estimator(method, K=6, **kw)),
               JS.cov_factor(jnp.asarray(Sigma), JEst(method, K=6, **kw)))
    for method in ("geometric_median", "krum"):
        with pytest.raises(ValueError, match="no asymptotic-normality"):
            TS.cov_factor(S, Estimator(method))
    for beta in (0.0, 0.1, 0.25):
        assert TS.trimmed_mean_variance_factor(beta) == \
            JS.trimmed_mean_variance_factor(beta)
    with pytest.raises(ValueError):
        TS.trimmed_mean_variance_factor(0.5)


def test_mom_cov_factor_diagonal_hazard():
    """The diagonal correlation Sigma_ll / sqrt(Sigma_ll)^2 rounds below 1
    in f32 for some Sigma_ll, and MOM's factor arcsin(corr) then falls
    3.45e-4 or 4.88e-4 short of pi/2 (ROADMAP.md §C). The port sets the
    diagonal to 1 and gives pi/2 Sigma_ll on every diagonal; repro falls
    short on some of these inputs."""
    v = np.float32(2.0) + np.arange(1, 400, dtype=np.float32) * np.float32(
        2 ** -22)
    S = np.diag(v).astype(np.float32)
    got = torch.diagonal(TS.mom_cov_factor(_t(S))).numpy()
    np.testing.assert_allclose(got, np.float32(np.pi / 2) * v, rtol=1e-6)
    want = np.diag(np.asarray(JS.mom_cov_factor(jnp.asarray(S))))
    # arcsin(1 - d) = pi/2 - sqrt(2 d): d = 2^-24 or 2^-23 below 1
    short = 1 - want / got
    hazard = [np.sqrt(2 * d) / (np.pi / 2) for d in (2.0 ** -24, 2.0 ** -23)]
    assert np.any(short > 2e-4)
    for x in short:
        assert x < 1e-6 or min(abs(x / h - 1) for h in hazard) < 1e-2, x


def test_contamination_inflation_exact():
    for alpha in (0.0, 0.05, 0.1, 0.2, 0.3):
        for est in ("vrmom", "median", "mom", "mean", "trimmed_mean",
                    Estimator("vrmom", K=20)):
            jest = JEst("vrmom", K=20) if isinstance(est, Estimator) else est
            assert TS.contamination_inflation(alpha, est) == \
                JS.contamination_inflation(alpha, jest)
    assert TS.contamination_inflation(0.1, "median") == pytest.approx(
        1 / 0.81, rel=1e-12)
    with pytest.raises(ValueError):
        TS.contamination_inflation(0.5)


# ---------------------------------------------------------------------------
# Symmetric-stack aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["median", "vrmom", "trimmed_mean",
                                    "mean"])
def test_aggregate_symmetric_stacked_exact(method):
    rng = np.random.RandomState(2)
    A = rng.randn(15, 4, 4).astype(np.float32)
    mats = A + A.transpose(0, 2, 1)
    est = Estimator(method, beta=0.2)
    out = aggregate_symmetric_stacked(_t(mats), est)
    assert torch.equal(out, out.T)
    full = Estimator(method, beta=0.2, backend="torch").apply(_t(mats))
    _close(out, full, rtol=0, atol=1e-6)
    _close(out, j_symmetric(jnp.asarray(mats), JEst(method, beta=0.2)),
           atol=1e-5)
    # [R, W, p, p]: each replication its own aggregate, in one stack
    stack = np.stack([mats, 2 * mats])
    outb = aggregate_symmetric_stacked(_t(stack), est)
    assert outb.shape == (2, 4, 4)
    _close(outb[1], aggregate_symmetric_stacked(_t(stack[1]), est), rtol=0,
           atol=0)
    if method == "median":  # 7 of 15 rows corrupted: the largest honest
        bad = mats.copy()
        bad[-7:] = 1e6
        out_bad = aggregate_symmetric_stacked(_t(bad), est).numpy()
        np.testing.assert_array_equal(out_bad, mats[:8].max(axis=0))


def test_aggregate_symmetric_stacked_rejects_bad_inputs():
    with pytest.raises(ValueError, match="symmetric stack"):
        aggregate_symmetric_stacked(torch.zeros(5, 3, 4), "median")
    with pytest.raises(ValueError, match="whole-vector"):
        aggregate_symmetric_stacked(torch.zeros(5, 3, 3), "krum")


# ---------------------------------------------------------------------------
# infer against repro.infer.infer
# ---------------------------------------------------------------------------

def _lin_case(seed, m1=21, n=120, p=4):
    rng = np.random.RandomState(seed)
    theta = np.linspace(1, 0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(m1, n, p).astype(np.float32)
    Y = (X @ theta + rng.randn(m1, n)).astype(np.float32)
    theta_hat = (theta + 0.02 * rng.randn(p)).astype(np.float32)
    return X, Y, theta_hat


def _log_case(seed, m1=21, n=150, p=3):
    rng = np.random.RandomState(seed)
    theta = np.linspace(1, 0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(m1, n, p).astype(np.float32)
    Y = (rng.rand(m1, n) < 1 / (1 + np.exp(-X @ theta))).astype(np.float32)
    return X, Y, (theta + 0.05 * rng.randn(p)).astype(np.float32)


@pytest.mark.parametrize("model,estimator,attack", [
    ("linear", "vrmom", "none"), ("linear", "vrmom", "signflip"),
    ("linear", "median", "alie"), ("linear", "mean", "none"),
    ("linear", "trimmed_mean", "omniscient"), ("logistic", "vrmom", "none"),
    ("logistic", "vrmom", "ipm")])
def test_infer_matches_repro(model, estimator, attack):
    X, Y, th = (_lin_case if model == "linear" else _log_case)(3)
    jp = (JR.LinearRegressionProblem() if model == "linear"
          else JR.LogisticRegressionProblem())
    tp = (TR.LinearRegressionProblem() if model == "linear"
          else TR.LogisticRegressionProblem())
    alpha = 0.0 if attack == "none" else 0.15
    kw = dict(estimator=estimator, K=8, level=0.9, alpha=alpha,
              attack=attack)
    want = JS.infer(jp, JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                    jnp.asarray(th), key=jax.random.PRNGKey(0), **kw)
    got = TS.infer(tp, TR.Shards(_t(X), _t(Y)), _t(th),
                   generator=torch.Generator(), **kw)
    # MOM's factor arcsin(corr) has an infinite slope at the diagonal's
    # corr = 1, which repro's f32 rounds to 1 or just below by the last bit
    # of Sigma_ll: up to 3.1e-4 relative on C_ll, spread over Xi by the two
    # solves
    # (test_mom_cov_factor_diagonal_hazard)
    rtol = 1e-3 if estimator == "median" else 1e-5
    for name in ("H", "Sigma", "cov"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        _close(g, w, rtol=1e-5 if name != "cov" else rtol,
               atol=1e-5 * np.abs(w).max())
    for name in ("lower", "upper", "se", "z"):
        _close(getattr(got.ci, name), getattr(want.ci, name), rtol=rtol,
               atol=1e-7)
    assert got.N == want.N == X.shape[0] * X.shape[1]
    assert torch.equal(got.H, got.H.T)


def test_infer_simultaneous_and_assumed_alpha_match_repro():
    X, Y, th = _lin_case(4)
    jargs = (JR.LinearRegressionProblem(),
             JR.Shards(jnp.asarray(X), jnp.asarray(Y)), jnp.asarray(th))
    targs = (TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)), _t(th))
    for kw in (dict(simultaneous=True), dict(alpha=0.1, assumed_alpha=0.0),
               dict(alpha=0.1)):
        want = JS.infer(*jargs, **kw)
        got = TS.infer(*targs, **kw)
        _close(got.ci.lower, want.ci.lower, atol=1e-7)
        _close(got.ci.upper, want.ci.upper, atol=1e-7)
    with pytest.raises(ValueError, match="generator"):
        TS.infer(*targs, alpha=0.1, attack="gaussian")


def test_infer_batched_equals_separate():
    """[R, m+1, n, p] shards and theta [R, p]: each replication's result is
    the one-replication call's, mimic's victim chosen inside each."""
    cases = [_lin_case(s) for s in (5, 6)]
    X = np.stack([c[0] for c in cases])
    Y = np.stack([c[1] for c in cases])
    th = np.stack([c[2] for c in cases])
    prob = TR.LinearRegressionProblem()
    kw = dict(alpha=0.15, attack="mimic", generator=torch.Generator())
    got = TS.infer(prob, TR.Shards(_t(X), _t(Y)), _t(th), **kw)
    assert got.cov.shape == (2, 4, 4) and got.ci.lower.shape == (2, 4)
    for r in range(2):
        one = TS.infer(prob, TR.Shards(_t(X[r]), _t(Y[r])), _t(th[r]), **kw)
        _close(got.cov[r], one.cov, rtol=1e-5, atol=1e-7)
        _close(got.ci.lower[r], one.ci.lower, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Coverage harness
# ---------------------------------------------------------------------------

def test_coverage_close_to_nominal_small_rep():
    """The small-rep cell of tests/test_infer.py at the same bounds: 95 %
    CIs under the gaussian attack at alpha = 0.1, 40 replications."""
    s = coverage_run(model="linear", attack="gaussian", alpha=0.1,
                     estimator="vrmom", reps=40, N_per_machine=200,
                     m_workers=100, p=5, rounds=6, level=0.95,
                     batch_size=10, device="cpu").summary()
    assert 0.85 <= s["coverage"] <= 1.0
    assert np.isfinite(s["mean_width"]) and s["mean_width"] > 0
    assert s["rmse"] < 0.05


def test_coverage_outputs_shapes():
    cell = coverage_run(model="linear", attack="none", alpha=0.0,
                        estimator="vrmom", reps=7, N_per_machine=100,
                        m_workers=20, p=3, rounds=3, batch_size=3,
                        device="cpu")
    assert cell.covered.shape == (7, 3) and cell.width.shape == (7, 3)
    assert cell.err.shape == (7, 3) and cell.covered.dtype == torch.bool
    s = cell.summary()
    assert s["reps"] == 7 and len(s["coverage_per_coord"]) == 3


def test_coverage_same_seed_same_draws_and_backends_agree():
    """Two cells with one seed see the same shards and attack draws: the
    plain ("torch") and kernel ("cuda", its plain version here) Estimator
    backends give the same cell, and the logistic label-flip cell runs."""
    kw = dict(model="linear", attack="gaussian", alpha=0.1, reps=6,
              N_per_machine=100, m_workers=20, p=3, rounds=4, batch_size=4,
              device="cpu")
    a = coverage_run(estimator=Estimator("vrmom", backend="torch"), **kw)
    b = coverage_run(estimator=Estimator("vrmom", backend="cuda"), **kw)
    _close(a.err, b.err, rtol=0, atol=1e-6)
    _close(a.width, b.width, rtol=1e-5, atol=1e-7)
    lf = coverage_run(model="logistic", attack="none", alpha=0.1,
                      labelflip=True, reps=4, N_per_machine=150,
                      m_workers=20, p=3, rounds=4, batch_size=4,
                      device="cpu").summary()
    assert np.isfinite(lf["rmse"]) and lf["rmse"] < 0.3
