"""repro_torch serving slice and estimator core against ``repro``.

The port's ``ServeEngine.generate`` and ``repro``'s, at the same weights
(``convert.params_from_jax``) and prompts, must give identical greedy
tokens: plain, and robust m=8 (vrmom, median, trimmed_mean; no attack and
signflip; shared and replicated replica compute; fused and unfused tail).
Under the gaussian attack tokens must equal the clean ones (the noise
streams of the two frameworks cannot match). Sampled tokens are compared
as distributions. The Estimator backends are held against ``repro``'s at
1e-5 (``tests/test_estimator.py``); deterministic attacks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.core import attacks as JA
from repro.core.estimator import Estimator as JEstimator
from repro.models import model as JM
from repro.serve import RobustDecodeConfig as JRobust
from repro.serve import Sampling as JSampling
from repro.serve import ServeEngine as JEngine
from repro.serve import robust as JR
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import attacks as TA
from repro_torch.core.estimator import Estimator
from repro_torch.serve import RobustDecodeConfig, Sampling, ServeEngine
from repro_torch.serve import robust as TR

torch.set_num_threads(1)

ESTIMATORS = ("vrmom", "median", "trimmed_mean")
B, S, N_NEW, MAX_LEN = 2, 12, 10, 40


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = np.random.RandomState(1).randint(0, jcfg.vocab, size=(B, S))
    plain = np.asarray(JEngine(jcfg, jp, max_len=MAX_LEN).generate(
        {"tokens": jnp.asarray(prompts)}, N_NEW))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts,
                plain=plain, jax_robust={})


def _jax_robust(st, estimator, attack):
    """repro's robust greedy tokens (default shared + fused), cached."""
    key = (estimator, attack)
    if key not in st["jax_robust"]:
        eng = JEngine(st["jcfg"], st["jp"], max_len=MAX_LEN,
                      robust=JRobust(m=8, estimator=estimator, K=8,
                                     attack=attack, alpha=0.25))
        st["jax_robust"][key] = np.asarray(eng.generate(
            {"tokens": jnp.asarray(st["prompts"])}, N_NEW,
            key=jax.random.PRNGKey(11)))
    return st["jax_robust"][key]


def _port(st, robust=None, **kw):
    return ServeEngine(st["tcfg"], st["tp"], max_len=MAX_LEN, robust=robust,
                       device="cpu", **kw)


def test_plain_greedy_matches_repro(slice_setup):
    st = slice_setup
    got = _port(st).generate({"tokens": st["prompts"]}, N_NEW).numpy()
    np.testing.assert_array_equal(got, st["plain"])


@pytest.mark.parametrize("backend", ["torch", "flash"])
def test_attention_backends_same_tokens(slice_setup, backend):
    st = slice_setup
    got = _port(st, attn_backend=backend).generate(
        {"tokens": st["prompts"]}, N_NEW).numpy()
    np.testing.assert_array_equal(got, st["plain"])


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("attack", ["none", "signflip"])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_robust_greedy_matches_repro(slice_setup, estimator, attack, share,
                                     fuse):
    st = slice_setup
    want = _jax_robust(st, estimator, attack)
    np.testing.assert_array_equal(want, st["plain"])  # repro's own contract
    rcfg = RobustDecodeConfig(m=8, estimator=estimator, K=8, attack=attack,
                              alpha=0.25, share_replica_compute=share,
                              fuse_tail=fuse)
    got = _port(st, rcfg).generate({"tokens": st["prompts"]}, N_NEW).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_gaussian_attack_tokens_equal_clean(slice_setup, estimator, share):
    st = slice_setup
    rcfg = RobustDecodeConfig(m=8, estimator=estimator, attack="gaussian",
                              alpha=0.25, share_replica_compute=share)
    got = _port(st, rcfg).generate(
        {"tokens": st["prompts"]}, N_NEW,
        generator=torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(got, st["plain"])


def test_topk1_equals_greedy(slice_setup):
    st = slice_setup
    eng = _port(st, RobustDecodeConfig(m=8))
    k1 = eng.generate({"tokens": st["prompts"]}, N_NEW,
                      Sampling("top_k", 1.0, top_k=1)).numpy()
    np.testing.assert_array_equal(k1, st["plain"])
    t = eng.generate({"tokens": st["prompts"]}, 6,
                     Sampling("temperature", 1.5)).numpy()
    assert ((t >= 0) & (t < st["tcfg"].vocab)).all()


def test_topk_sampling_distribution(slice_setup):
    """Fused top-k draws over B4's (value, index) lists, the unfused path
    masks the vocabulary: over 256 draws per row the two port paths and
    repro's fused path agree within the TV bound of
    ``tests/test_serve.py``."""
    V = slice_setup["tcfg"].vocab
    logits_r = (4.0 * np.random.RandomState(0).randn(4, 2, V)
                ).astype(np.float32)
    reps = 256
    big = np.tile(logits_r, (1, reps, 1))
    draws = {}
    for fused in (True, False):
        rcfg = RobustDecodeConfig(m=4, alpha=0.0, estimator="vrmom",
                                  fuse_tail=fused)
        draws[fused] = TR.robust_sample(
            torch.from_numpy(big), rcfg, torch.Generator().manual_seed(1),
            Sampling("top_k", 1.0, top_k=5)).numpy().reshape(reps, 2)
    jr = JRobust(m=4, alpha=0.0, attack="none", estimator="vrmom",
                 fuse_tail=True)
    akey, skey = jax.random.split(jax.random.PRNGKey(1))
    draws["repro"] = np.asarray(JR.robust_sample(
        jnp.asarray(big), jr, akey, skey,
        JSampling("top_k", temperature=1.0, top_k=5))).reshape(reps, 2)
    agg = TR.robust_logits(torch.from_numpy(logits_r), rcfg)
    top5 = torch.sort(agg, dim=-1, descending=True, stable=True
                      ).indices[:, :5].numpy()
    for d in draws.values():
        for b in range(2):
            assert set(np.unique(d[:, b])) <= set(top5[b])
    for b in range(2):
        p = {k: np.array([(d[:, b] == t).mean() for t in top5[b]])
             for k, d in draws.items()}
        assert 0.5 * np.abs(p[True] - p[False]).sum() < 0.15, (b, p)
        assert 0.5 * np.abs(p[True] - p["repro"]).sum() < 0.15, (b, p)


def test_robust_decode_step_shared_equals_replicated(slice_setup):
    st = slice_setup
    from repro_torch.models import model as TM

    toks = torch.from_numpy(st["prompts"])
    _, caches = TM.prefill(st["tp"], st["tcfg"], {"tokens": toks},
                           cache_len=MAX_LEN)
    tok = toks[:, -1]
    shared = RobustDecodeConfig(m=8, attack="signflip")
    rep = RobustDecodeConfig(m=8, attack="signflip",
                             share_replica_compute=False)
    rep_caches = TR.stack_replicas(
        caches._replace(k=caches.k.clone(), v=caches.v.clone()), 8)
    a, _ = TR.robust_decode_step(st["tp"], st["tcfg"], caches, tok, shared)
    b, new = TR.robust_decode_step(st["tp"], st["tcfg"], rep_caches, tok, rep)
    # batch m*B against batch B: the matmuls may sum in another order
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.argmax(a, -1), torch.argmax(b, -1))
    # pos is per row, tiled over the replicas: [m, B]
    assert new.k.shape[0] == 8 and new.pos.tolist() == [[S + 1] * B] * 8
    flat = TR.flatten_replicas(new, 8)
    torch.testing.assert_close(TR.unflatten_replicas(flat, 8).k, new.k)


def test_robust_config_coercion_and_refusals():
    tm = RobustDecodeConfig(m=8, estimator="trimmed_mean", alpha=0.25)
    assert tm.estimator.beta == 0.25
    assert RobustDecodeConfig(m=8, K=6).estimator.K == 6
    with pytest.raises(ValueError, match="whole-vector"):
        RobustDecodeConfig(m=8, estimator="krum")
    # the adaptive tier aggregates a full replica stack: accepted, with
    # repro's coercion (K binds to vrmom only)
    assert RobustDecodeConfig(m=8, estimator="auto_gm").estimator.method \
        == "auto_gm"
    assert RobustDecodeConfig(m=8, K=6, estimator="vrmom_adaptive"
                              ).estimator.K == 10
    with pytest.raises(ValueError, match="whole-vector"):
        RobustDecodeConfig(m=8, estimator="geometric_median")
    with pytest.raises(ValueError, match="0 rows"):
        RobustDecodeConfig(m=8, estimator=Estimator("trimmed_mean", beta=0.1))
    with pytest.raises(ValueError, match="honest"):
        TR.replica_mask(8, 0.5)
    mask = TR.replica_mask(8, 0.25)
    assert int(mask.sum()) == 2 and not bool(mask[0])


# ---------------------------------------------------------------------------
# Estimator core and attacks
# ---------------------------------------------------------------------------

def _spec_kw(method):
    return {"trimmed_mean": dict(beta=0.2), "vrmom": dict(K=8)}.get(method,
                                                                     {})


@pytest.mark.parametrize("shape", [(7, 257), (8, 4, 97)])
@pytest.mark.parametrize("backend", ["torch", "ref", "cuda", "auto"])
@pytest.mark.parametrize("method", ["mean", "median", "mom", "trimmed_mean",
                                    "vrmom"])
def test_estimator_backends_match_repro(method, backend, shape):
    x = (4.0 * np.random.RandomState(len(shape)).randn(*shape) + 1.5
         ).astype(np.float32)
    want = np.asarray(JEstimator(method=method, backend="jnp",
                                 **_spec_kw(method)).apply(jnp.asarray(x)))
    got = Estimator(method=method, backend=backend,
                    **_spec_kw(method)).apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_estimator_axis_and_dispatch():
    x = np.random.RandomState(3).randn(5, 6, 4).astype(np.float32)
    want = np.asarray(JEstimator("vrmom", backend="jnp").apply(
        jnp.asarray(x), axis=1))
    for backend in ("torch", "cuda"):
        got = Estimator("vrmom", backend=backend).apply(torch.from_numpy(x),
                                                       axis=1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert Estimator("vrmom").resolve_backend() == "cuda"
    assert Estimator("mean").resolve_backend() == "ref"
    with pytest.raises(ValueError, match="unknown backend"):
        Estimator("median", backend="pallas").validate(4)


@pytest.mark.parametrize("top_k", [0, 3])
def test_apply_sample_backends_agree(top_k):
    x = torch.from_numpy(np.round(4 * np.random.RandomState(2).randn(
        8, 3, 50)).astype(np.float32))
    outs = [Estimator("median", backend=b).apply_sample(x, top_k=top_k)
            for b in ("torch", "cuda")]
    for a, b in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["signflip", "zero", "bitflip",
                                  "wrong_value", "omniscient", "alie", "ipm",
                                  "mimic", "none"])
def test_deterministic_attacks_match_repro(name):
    v = np.random.RandomState(4).randn(9, 3, 11).astype(np.float32)
    jmask = JA.byzantine_mask(9, 0.3)
    tmask = TA.byzantine_mask(9, 0.3)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = np.asarray(JA.get(name)(jax.random.PRNGKey(0), jnp.asarray(v),
                                   jmask))
    got = TA.get(name)(None, torch.from_numpy(v), tmask).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gaussian_attack_draws_from_generator():
    v = torch.zeros(8, 2, 1000)
    mask = TA.byzantine_mask(8, 0.3)
    a = TA.gaussian(torch.Generator().manual_seed(0), v, mask)
    b = TA.gaussian(torch.Generator().manual_seed(0), v, mask)
    torch.testing.assert_close(a, b)
    assert torch.all(a[~mask] == 0)
    assert abs(float(a[mask].std()) - 200 ** 0.5) < 0.5
    with pytest.raises(ValueError, match="Generator"):
        TA.gaussian(None, v, mask)
