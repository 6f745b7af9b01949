"""repro_torch's estimator core and Algorithm 1 (RCSL) against ``repro``.

The same numpy inputs, made from a seed, go through ``repro.core`` and
``repro_torch.core`` on the CPU. Tolerances: 1e-5 for the f32 estimators
and the Problems (sums in another order), 1e-12 for the host float64
theory functions, 1e-4 for RCSL trajectories (ten rounds of f32 solves).
JAX PRNG streams and ``torch.Generator`` streams never match, so random
attacks are checked as a contract, and random data as a distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcsl as JR
from repro.core import vrmom as JV
from repro_torch.core import rcsl as TR
from repro_torch.core import vrmom as TV
from repro_torch.core.estimator import Estimator

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("scale", ["mad", "master", "array"])
def test_core_vrmom_matches_repro(scale, axis):
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(4, 21, 6) + 0.5).astype(np.float32)
    x = np.moveaxis(x, 1, axis)                      # 21 workers on `axis`
    master = rng.randn(*np.moveaxis(np.zeros((4, 50, 6)), 1, axis).shape
                       ).astype(np.float32)
    kw, kw_t = {}, {}
    if scale == "master":
        if axis != 0:  # repro's master scale takes its samples on axis 0
            master = np.moveaxis(master, axis, 0)
        kw = dict(scale="master", master_samples=jnp.asarray(master))
        kw_t = dict(scale="master",
                    master_samples=_t(np.moveaxis(master, 0, axis)))
    elif scale == "array":
        s = (0.3 + rng.rand(*np.delete(x.shape, axis))).astype(np.float32)
        kw, kw_t = dict(scale=jnp.asarray(s)), dict(scale=_t(s))
    for K in (1, 8, 10):
        if scale == "master" and axis != 0:
            want = JV.vrmom(jnp.asarray(np.moveaxis(x, axis, 0)), K=K, **kw)
        else:
            want = JV.vrmom(jnp.asarray(x), K=K, axis=axis, **kw)
        _close(TV.vrmom(_t(x), K=K, axis=axis, **kw_t), want)
    _close(TV.mom(_t(x), axis=axis), JV.mom(jnp.asarray(x), axis=axis),
           rtol=0, atol=0)
    _close(TV.mad_scale(_t(x), axis=axis),
           JV.mad_scale(jnp.asarray(x), axis=axis))
    _close(TV.master_scale(_t(master), axis=0),
           JV.master_scale(jnp.asarray(master)))


def test_core_vrmom_eps_fallback_and_scale_errors():
    """All-equal columns: the scale is 0 and VRMOM returns the median
    exactly, as in repro; unknown and incomplete scale specs raise."""
    x = np.tile(np.float32([[1.5, -2.0, 0.25]]), (7, 1))
    x[-1] = 1e6  # one corrupted row keeps the MAD at 0
    got = TV.vrmom(_t(x), K=10)
    np.testing.assert_array_equal(got.numpy(), x[0])
    np.testing.assert_array_equal(got.numpy(),
                                  _np(JV.vrmom(jnp.asarray(x), K=10)))
    with pytest.raises(ValueError, match="master_samples"):
        TV.vrmom(_t(x), scale="master")
    with pytest.raises(ValueError, match="unknown scale"):
        TV.vrmom(_t(x), scale="iqr")


@pytest.mark.parametrize("K", [1, 2, 10, 100])
def test_theory_functions_match_repro(K):
    assert TV.sigma_k_sq(K) == pytest.approx(JV.sigma_k_sq(K), rel=1e-12)
    assert TV.vrmom_correction_bound(K) == pytest.approx(
        JV.vrmom_correction_bound(K), rel=1e-12)
    assert TV.psi_sum(K) == pytest.approx(JV.psi_sum(K), rel=1e-12)
    assert TV.sigma_mom_sq() == JV.sigma_mom_sq()
    for a, b, rho in ((0.5, -0.3, 0.6), (1.2, 1.2, -0.8), (0.3, 0.1, 1.0),
                      (0.5, -0.7, -1.0)):
        assert TV._phi2_cdf_grid(a, b, rho) == pytest.approx(
            JV._phi2_cdf_grid(a, b, rho), rel=1e-12, abs=1e-12)


def test_asymptotic_covs_match_repro():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 3))
    Sigma = A @ A.T + 0.5 * np.eye(3)
    np.testing.assert_allclose(TV.vrmom_asymptotic_cov(Sigma, K=4),
                               JV.vrmom_asymptotic_cov(Sigma, K=4),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(TV.mom_asymptotic_cov(Sigma),
                               JV.mom_asymptotic_cov(Sigma), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------

def _logistic_loss_t(th, x, y):
    eta = x @ th
    return torch.nn.functional.softplus(eta) - y * eta


def _logistic_loss_j(th, x, y):
    eta = x @ th
    return jax.nn.softplus(eta) - y * eta


PROBLEMS = {
    "linear": (lambda: JR.LinearRegressionProblem(ridge=0.01),
               lambda: TR.LinearRegressionProblem(ridge=0.01)),
    "logistic": (lambda: JR.LogisticRegressionProblem(),
                 lambda: TR.LogisticRegressionProblem()),
    "generic": (lambda: JR.GenericProblem(_logistic_loss_j, master_steps=60,
                                          lr=0.5),
                lambda: TR.GenericProblem(_logistic_loss_t, master_steps=60,
                                          lr=0.5)),
}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_problem_methods_match_repro(name):
    jp, tp = (f() for f in PROBLEMS[name])
    rng = np.random.RandomState(5)
    X = rng.randn(120, 4).astype(np.float32)
    theta = (0.4 * rng.randn(4)).astype(np.float32)
    eta = X @ theta
    Y = (rng.rand(120) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    if name == "linear":
        Y = (eta + rng.randn(120)).astype(np.float32)
    lt = (0.05 * rng.randn(4)).astype(np.float32)
    jargs = (jnp.asarray(theta), jnp.asarray(X), jnp.asarray(Y))
    targs = (_t(theta), _t(X), _t(Y))
    for meth in ("local_grad", "per_sample_grads", "local_hessian"):
        _close(getattr(tp, meth)(*targs), getattr(jp, meth)(*jargs))
    for got, want in zip(tp.local_moments(*targs), jp.local_moments(*jargs)):
        _close(got, want)
    _close(tp.init_theta(_t(X), _t(Y)), jp.init_theta(*jargs[1:]))
    _close(tp.master_solve(*targs, _t(lt)),
           jp.master_solve(*jargs, jnp.asarray(lt)))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_problem_methods_take_leading_axes(name):
    """[R, m+1, n, p] data with theta [R, 1, p]: each slice is the
    one-shard call."""
    tp = PROBLEMS[name][1]()
    rng = np.random.RandomState(6)
    X = _t(rng.randn(2, 3, 40, 3).astype(np.float32))
    Y = _t((rng.rand(2, 3, 40) < 0.5).astype(np.float32))
    theta = _t((0.3 * rng.randn(2, 1, 3)).astype(np.float32))
    for meth in ("local_grad", "per_sample_grads", "local_hessian"):
        got = getattr(tp, meth)(theta, X, Y)
        for r in range(2):
            for j in range(3):
                _close(got[r, j], getattr(tp, meth)(theta[r, 0], X[r, j],
                                                    Y[r, j]), atol=1e-6)
    g1, g2 = tp.local_moments(theta, X, Y)
    w1, w2 = tp.local_moments(theta[1, 0], X[1, 2], Y[1, 2])
    _close(g1[1, 2], w1, atol=1e-6)
    _close(g2[1, 2], w2, atol=1e-6)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _lin_data(seed, m1=11, n=150, p=4, reps=None):
    rng = np.random.RandomState(seed)
    lead = () if reps is None else (reps,)
    theta = np.linspace(1.0, 0.0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(*lead, m1, n, p).astype(np.float32)
    Y = (X @ theta + rng.randn(*lead, m1, n)).astype(np.float32)
    return X, Y, theta


def _log_data(seed, m1=11, n=200, p=4):
    rng = np.random.RandomState(seed)
    theta = np.linspace(1.0, 0.0, p).astype(np.float32) / np.sqrt(p)
    X = rng.randn(m1, n, p).astype(np.float32)
    Y = (rng.rand(m1, n) < 1 / (1 + np.exp(-X @ theta))).astype(np.float32)
    return X, Y, theta


@pytest.mark.parametrize("case", [
    ("none", "vrmom", "master"), ("signflip", "vrmom", "master"),
    ("omniscient", "vrmom", "master"), ("alie", "vrmom", "mad"),
    ("signflip", "median", "master"), ("alie", "trimmed_mean", "master")])
def test_rcsl_matches_repro(case):
    attack, agg, scale = case
    X, Y, _ = _lin_data(11)
    kw = dict(alpha=0.2, attack=attack, aggregator=agg, K=10, scale=scale,
              rounds=5, tol=None)
    if agg == "trimmed_mean":
        kw["beta"] = 0.25
    jt, jtraj = JR.rcsl(JR.LinearRegressionProblem(),
                        JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                        jax.random.PRNGKey(0), **kw)
    tt, ttraj = TR.rcsl(TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)),
                        None, **kw)
    assert ttraj.shape == (6, 4)
    _close(ttraj, jtraj, rtol=1e-4, atol=1e-4)
    _close(tt, jt, rtol=1e-4, atol=1e-4)


def test_rcsl_logistic_labelflip_matches_repro():
    X, Y, theta = _log_data(7)
    kw = dict(alpha=0.2, labelflip=True, rounds=6)
    jt, jtraj = JR.rcsl(JR.LogisticRegressionProblem(),
                        JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                        jax.random.PRNGKey(0), **kw)
    tt, ttraj = TR.rcsl(TR.LogisticRegressionProblem(),
                        TR.Shards(_t(X), _t(Y)), None, **kw)
    _close(ttraj, jtraj, rtol=1e-4, atol=1e-4)
    _close(tt, jt, rtol=1e-4, atol=1e-4)


def test_rcsl_tol_freezes_each_replication():
    """The stop rule runs a fixed number of rounds and repeats each
    replication's converged iterate, as repro's scan does."""
    X, Y, _ = _lin_data(12)
    kw = dict(alpha=0.0, rounds=6, tol=1e-3)
    jt, jtraj = JR.rcsl(JR.LinearRegressionProblem(),
                        JR.Shards(jnp.asarray(X), jnp.asarray(Y)),
                        jax.random.PRNGKey(0), **kw)
    tt, ttraj = TR.rcsl(TR.LinearRegressionProblem(), TR.Shards(_t(X), _t(Y)),
                        **kw)
    _close(ttraj, jtraj, rtol=1e-4, atol=1e-4)
    assert torch.equal(ttraj[-1], ttraj[-2])  # frozen before the last round


def test_rcsl_gaussian_attack_contract():
    """Random attack draws differ across PRNGs: hold the contract instead.
    VRMOM-RCSL under the gaussian attack improves on the master-only start
    and stays near theta*, where the mean is destroyed."""
    X, Y, theta = _lin_data(13, m1=21, n=200)
    sh = TR.Shards(_t(X), _t(Y))
    gen = torch.Generator().manual_seed(0)
    est, traj = TR.rcsl(TR.LinearRegressionProblem(), sh, gen, alpha=0.15,
                        attack="gaussian", rounds=8)
    err = float(torch.sqrt(torch.mean((est - _t(theta)) ** 2)))
    err0 = float(torch.sqrt(torch.mean((traj[0] - _t(theta)) ** 2)))
    assert err < err0 and err < 0.08
    gen = torch.Generator().manual_seed(0)
    est_mean, _ = TR.rcsl(TR.LinearRegressionProblem(), sh, gen, alpha=0.15,
                          attack="gaussian", rounds=8, aggregator="mean")
    err_mean = float(torch.sqrt(torch.mean((est_mean - _t(theta)) ** 2)))
    assert err_mean > 5 * err
    with pytest.raises(ValueError, match="Generator"):
        TR.rcsl(TR.LinearRegressionProblem(), sh, None, alpha=0.15,
                attack="gaussian", rounds=1)


def test_rcsl_generic_problem_matches_linear():
    X, Y, _ = _lin_data(14, m1=11, n=300, p=4)
    sh = TR.Shards(_t(X), _t(Y))
    prob_g = TR.GenericProblem(loss_fn=lambda th, x, y: (y - x @ th) ** 2,
                               master_steps=400, lr=0.2)
    est_g, _ = TR.rcsl(prob_g, sh, rounds=5)
    est_c, _ = TR.rcsl(TR.LinearRegressionProblem(), sh, rounds=5)
    _close(est_g, est_c, rtol=0, atol=2e-2)


@pytest.mark.parametrize("attack", ["none", "signflip", "omniscient", "alie",
                                    "ipm", "mimic", "bitflip"])
@pytest.mark.parametrize("agg,scale", [("vrmom", "master"), ("vrmom", "mad"),
                                       ("median", "master")])
def test_rcsl_batched_equals_separate_runs(attack, agg, scale):
    """R replications in one run equal R runs of one; mimic picks its
    victim inside each replication."""
    X, Y, _ = _lin_data(15, m1=11, n=80, p=3, reps=3)
    kw = dict(alpha=0.2, attack=attack, aggregator=agg, scale=scale,
              rounds=4)
    tb, trajb = TR.rcsl(TR.LinearRegressionProblem(),
                        TR.Shards(_t(X), _t(Y)), **kw)
    assert tb.shape == (3, 3) and trajb.shape == (3, 5, 3)
    for r in range(3):
        t1, traj1 = TR.rcsl(TR.LinearRegressionProblem(),
                            TR.Shards(_t(X[r]), _t(Y[r])), **kw)
        _close(trajb[r], traj1, rtol=1e-5, atol=1e-6)


def test_rcsl_rejects_consensus_and_unknown_backends():
    """The consensus backend runs (tests/test_torch_consensus.py holds it
    against repro) and refuses a config the peers cannot tolerate before
    any compute; an unknown backend raises."""
    from repro_torch.dist.consensus import ConsensusConfig

    X, Y, _ = _lin_data(16)
    sh = TR.Shards(_t(X), _t(Y))
    theta, traj = TR.rcsl(TR.LinearRegressionProblem(), sh, rounds=2,
                          reduce_backend="consensus")
    assert traj.shape == (3, 4) and torch.isfinite(traj).all()
    with pytest.raises(ValueError, match="n > 5f"):
        TR.rcsl(TR.LinearRegressionProblem(), sh, reduce_backend="consensus",
                consensus=ConsensusConfig(f=3))
    with pytest.raises(ValueError, match="reduce_backend"):
        TR.rcsl(TR.LinearRegressionProblem(), sh, reduce_backend="gossip")


def test_aggregate_gradients_dispatch():
    """Master-scale VRMOM runs the plain core estimator; the MAD scale and
    every other method the Estimator, whose "torch" and "auto" backends
    agree on the CPU; an explicit Estimator keeps its own K."""
    rng = np.random.RandomState(17)
    g = _t(rng.randn(2, 11, 5).astype(np.float32))
    psg = _t(rng.randn(2, 40, 5).astype(np.float32))
    got = TR.aggregate_gradients(g, K=8, scale="master",
                                 per_sample_grads_master=psg)
    want = torch.stack([TV.vrmom(g[r], K=8, scale="master",
                                 master_samples=psg[r]) for r in range(2)])
    _close(got, want, rtol=0, atol=0)
    for method in ("vrmom", "median", "trimmed_mean", "mean"):
        auto = TR.aggregate_gradients(g, method, K=8, scale="mad", beta=0.2)
        plain = TR.aggregate_gradients(
            g, Estimator(method, K=8, beta=0.2, backend="torch"),
            scale="mad")
        _close(auto, plain, atol=1e-6)
    est = Estimator("vrmom", K=3, backend="torch")
    _close(TR.aggregate_gradients(g, est, K=8, scale="mad"),
           est.apply(g, axis=1), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_make_shards_toeplitz_within_sampling_error():
    p, rho, mu = 4, 0.5, 0.5
    theta = TR.paper_theta_star(p, device="cpu")
    sh = TR.make_shards(0, N_per_machine=500, m_workers=9, p=p,
                        theta_star=theta, mu_x=mu, reps=4, device="cpu")
    assert sh.X.shape == (4, 10, 500, p) and sh.Y.shape == (4, 10, 500)
    Xf = sh.X.reshape(-1, p).double()
    N = Xf.shape[0]
    idx = np.arange(p)
    want = rho ** np.abs(idx[:, None] - idx[None, :])
    cov = torch.cov(Xf.T).numpy()
    np.testing.assert_allclose(cov, want, atol=6 / np.sqrt(N))
    np.testing.assert_allclose(Xf.mean(0).numpy(), mu, atol=6 / np.sqrt(N))
    resid = (sh.Y - sh.X @ theta).reshape(-1)
    assert float(resid.var()) == pytest.approx(1.0, abs=6 * np.sqrt(2 / N))
    lg = TR.make_shards(torch.Generator().manual_seed(1), N_per_machine=50,
                        m_workers=3, p=p, theta_star=theta, model="logistic",
                        device="cpu")
    assert lg.X.shape == (4, 50, p)
    assert set(lg.Y.unique().tolist()) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        TR.make_shards(0, 10, 2, p, theta, model="poisson", device="cpu")


@pytest.mark.parametrize("p", [1, 2, 5, 30])
def test_paper_theta_star_exact(p):
    np.testing.assert_array_equal(TR.paper_theta_star(p, device="cpu").numpy(),
                                  _np(JR.paper_theta_star(p)))
