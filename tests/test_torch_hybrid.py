"""repro_torch's hybrid (zamba2) stack, and the ssm and hybrid families
served, against ``repro``.

Both packages run zamba2-7b and mamba2-2.7b at their ``reduced()`` sizes
in f32 at the same weights (``convert.params_from_jax``); prompts and
requests are numpy. The reduced hybrid has 4 mamba layers and the shared
block every 2 (2 applications, a tail of 0 whose one ``mamba_t`` layer
runs nowhere); a 5-layer variant has a tail of 1. Tolerances: 1e-4 on f32
logits and caches (``test_torch_models.py``'s); greedy tokens exact:
``generate`` against ``repro``'s ``ServeEngine.generate``, robust greedy
under signflip and gaussian against the clean tokens (shared and
replicated, fused and unfused), ``generate`` against
``generate_python_loop``, the pool against each request's solo
``generate`` and against ``repro``'s ``Scheduler`` on
``tests/test_serve.py:170-193``'s request set. Under gaussian the two
frameworks' noise streams differ, so the tokens held equal are the clean
ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.models import model as JM
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import hybrid as TH
from repro_torch.models import model as TM
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (Request, RobustDecodeConfig, Scheduler,
                               ServeEngine)
from repro_torch.serve import cache as TC

torch.set_num_threads(1)

NAMES = ["mamba2-2.7b", "zamba2-7b"]
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))
_MODELS = {}


def _model(name, **kw):
    """(repro's config, the port's, repro's params, the port's), reduced
    with ``kw`` replaced, cached."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jc = dataclasses.replace(j_get_arch(name).reduced(), **kw)
        tc = dataclasses.replace(t_get_arch(name).reduced(), **kw)
        jp = JM.init(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _j_states(jcache, cfg):
    """``repro``'s HybridCache mamba states in the port's flat order:
    group g's layer j at g * every + j, then the tail."""
    every = cfg.hybrid_attn_every
    G = cfg.n_layers // every
    out = {}
    for f in ("h", "conv", "conv_bc"):
        g = np.asarray(getattr(jcache.mamba_g, f))
        parts = [g.reshape((G * every,) + g.shape[2:])]
        if jcache.mamba_t is not None:
            parts.append(np.asarray(getattr(jcache.mamba_t, f)))
        out[f] = np.concatenate(parts)
    return out


# -- the hybrid stack --------------------------------------------------------

@pytest.mark.parametrize("n_layers", [4, 5], ids=["tail0", "tail1"])
def test_hybrid_prefill_and_teacher_forced_decode_match(n_layers):
    """Reduced zamba2-7b (tail 0) and 5 layers (tail 1): prefill logits, the
    mamba states in ``repro``'s order, the shared block's K/V one slot an
    application, then 6 decode steps fed the same tokens, within 1e-4."""
    jc, tc, jp, tp = _model("zamba2-7b", n_layers=n_layers)
    toks = np.random.RandomState(1).randint(0, tc.vocab, size=(2, 21))
    feed = np.random.RandomState(2).randint(0, tc.vocab, size=(2, 6))
    jl, jcache = _j_prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                            cache_len=30)
    tl, tcache = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)},
                            cache_len=30)
    assert isinstance(tcache, TH.HybridCache)
    assert tcache.h.shape[0] == n_layers and tcache.k.shape[:3] == (2, 2, 30)
    _close(tl, jl, 1e-4)
    for f, want in _j_states(jcache, jc).items():
        _close(getattr(tcache, f), want, 1e-4)
    _close(tcache.k, jcache.attn_g.k, 1e-4)
    _close(tcache.v, jcache.attn_g.v, 1e-4)
    for s in range(feed.shape[1]):
        jl, jcache = _j_decode(jp, jc, jcache,
                               jnp.asarray(feed[:, s], jnp.int32))
        tl, tcache = TM.decode_step(tp, tc, tcache,
                                    torch.from_numpy(feed[:, s]))
        _close(tl, jl, 1e-4)
    for f, want in _j_states(jcache, jc).items():
        _close(getattr(tcache, f), want, 1e-4)
    _close(tcache.k, jcache.attn_g.k, 1e-4)
    assert tcache.pos.tolist() == [27, 27]


def test_hybrid_unused_tail_layer():
    """At tail 0 ``repro`` keeps one ``mamba_t`` layer and runs none: moving
    its weights changes neither package's logits (the port's, bit for
    bit)."""
    jc, tc, jp, tp = _model("zamba2-7b")
    toks = np.random.RandomState(3).randint(0, tc.vocab, size=(2, 10))
    tl, _ = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    jl, _ = _j_prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    moved_t = dict(tp, mamba_t=jax.tree.map(lambda x: x + 1.0,
                                            tp["mamba_t"]))
    moved_j = dict(jp, mamba_t=jax.tree.map(lambda x: x + 1.0,
                                            jp["mamba_t"]))
    tl2, _ = TM.prefill(moved_t, tc, {"tokens": torch.from_numpy(toks)})
    jl2, _ = _j_prefill(moved_j, jc, {"tokens": jnp.asarray(toks)})
    assert torch.equal(tl, tl2)
    np.testing.assert_array_equal(np.asarray(jl), np.asarray(jl2))
    assert tp["mamba_t"]["norm"].shape == (1, tc.d_model)


def test_hybrid_shared_block_is_shared():
    """One ``shared`` param set serves every application: moving its
    ``in_proj`` moves the logits, and the two applications' K/V differ
    (each its own cache slot)."""
    _, tc, _, tp = _model("zamba2-7b")
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(0, tc.vocab, size=(1, 9)))
    logits, caches = TM.prefill(tp, tc, {"tokens": toks})
    assert not torch.equal(caches.k[0], caches.k[1])
    moved = dict(tp, shared=dict(tp["shared"],
                                 in_proj=tp["shared"]["in_proj"] * 1.5))
    assert not torch.equal(TM.prefill(moved, tc, {"tokens": toks})[0],
                           logits)


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("name,kv", [("mamba2-2.7b", None),
                                     ("zamba2-7b", None),
                                     ("zamba2-7b", "int8")],
                         ids=["mamba2", "zamba2", "zamba2-int8"])
def test_greedy_tokens_match_repro(name, kv):
    """``ServeEngine.generate`` on both sides: a 14-token prompt (one padded
    chunk of 16) and 8 new tokens, greedy, exact; zamba2 also with an int8
    KV cache for its shared block."""
    jc, tc, jp, tp = _model(name)
    toks = np.random.RandomState(4).randint(0, tc.vocab, size=(2, 14))
    want = np.asarray(JEngine(jc, jp, max_len=22, kv_dtype=kv).generate(
        {"tokens": jnp.asarray(toks)}, 8))
    got = ServeEngine(tc, tp, max_len=22, kv_dtype=kv,
                      device="cpu").generate({"tokens": toks}, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
@pytest.mark.parametrize("attack", ["signflip", "gaussian"])
@pytest.mark.parametrize("name", NAMES)
def test_robust_greedy_under_attack_equals_clean(name, attack, share):
    """Robust m = 8 VRMOM K 8 at alpha 0.25, fused and unfused tails: the
    tokens under attack are the clean tokens, in both layouts (the
    replicated one decodes 8 replica rows of every state)."""
    _, tc, _, tp = _model(name)
    batch = {"tokens": np.random.RandomState(5).randint(0, tc.vocab,
                                                         size=(2, 10))}
    clean = ServeEngine(tc, tp, max_len=18, device="cpu").generate(batch, 8)
    for fuse in (True, False):
        rcfg = RobustDecodeConfig(m=8, estimator="vrmom", K=8, alpha=0.25,
                                  attack=attack, fuse_tail=fuse,
                                  share_replica_compute=share)
        got = ServeEngine(tc, tp, max_len=18, robust=rcfg,
                          device="cpu").generate(batch, 8)
        torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize("robust", ["none", "shared", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_equals_python_loop(name, robust):
    """``generate`` (the prefill written into the engine's buffers, the
    replicas copied, every step over those buffers) equals the eager loop,
    twice on one engine (the second reuses the buffers)."""
    _, tc, _, tp = _model(name)
    rcfg = None if robust == "none" else RobustDecodeConfig(
        m=8, attack="gaussian", share_replica_compute=robust == "shared")
    eng = ServeEngine(tc, tp, max_len=24, robust=rcfg, device="cpu")
    for seed in (6, 7):
        batch = {"tokens": np.random.RandomState(seed).randint(
            0, tc.vocab, size=(3, 11))}
        torch.testing.assert_close(eng.generate(batch, 9),
                                   eng.generate_python_loop(batch, 9),
                                   rtol=0, atol=0)


def _serve_requests(vocab):
    """``tests/test_serve.py:170-193``'s requests: 3 prompts of 5, 8 and 11
    tokens (numpy seed 3), 4 new tokens each."""
    rs = np.random.RandomState(3)
    return [rs.randint(0, vocab, size=(5 + 3 * i,)) for i in range(3)]


@pytest.mark.parametrize("name", NAMES)
def test_pool_equals_solo_and_repro(name):
    """``test_pool_decode_other_families`` on both packages: 3 requests
    through 2 slots (max_len 40, blocks of 2), each completion equal to its
    solo ``generate`` and to ``repro``'s ``Scheduler``'s, exactly; the same
    under signflip on 8 shared replicas."""
    jc, tc, jp, tp = _model(name)
    reqs = _serve_requests(tc.vocab)
    jeng = JEngine(jc, jp, max_len=40, n_slots=2)
    jsched = JScheduler(jeng, decode_block=2)
    juids = [jsched.submit(JRequest(tokens=r, max_new_tokens=4))
             for r in reqs]
    jdone = jsched.run()
    want = [list(map(int, jdone[u].tokens)) for u in juids]
    for robust in (None, RobustDecodeConfig(m=8, attack="signflip")):
        eng = ServeEngine(tc, tp, max_len=40, n_slots=2, robust=robust,
                          device="cpu")
        sched = Scheduler(eng, decode_block=2)
        uids = [sched.submit(Request(tokens=r, max_new_tokens=4))
                for r in reqs]
        done = sched.run()
        got = [list(map(int, done[u].tokens)) for u in uids]
        assert got == want
        for r, t in zip(reqs, got):
            assert t == eng.generate({"tokens": r[None]}, 4)[0].tolist()


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_admission_into_an_evicted_slot(name, share):
    """A slot freed mid-decode keeps decoding (its state moves: an SSM state
    is masked by no length) until a new request is admitted there; that
    request's tokens equal its solo ``generate``: the admission overwrote
    every state tensor of the slot, in every replica row."""
    _, tc, _, tp = _model(name)
    rs = np.random.RandomState(8)
    a, b, c = (rs.randint(0, tc.vocab, size=(n,)) for n in (12, 7, 9))
    eng = ServeEngine(tc, tp, max_len=40, n_slots=2, device="cpu",
                      robust=RobustDecodeConfig(m=8, attack="signflip",
                                                share_replica_compute=share))
    pool = eng.make_pool()
    pool, ta = eng.admit(pool, 0, {"tokens": a[None]})
    pool, tb = eng.admit(pool, 1, {"tokens": b[None]})
    pool, _ = eng.decode_pool(pool, torch.tensor([ta, tb]), 3)
    pool = eng.evict(pool, 1)
    rows = [r * pool.n_slots + 1 for r in range(pool.m)]  # slot 1's rows
    before = pool.caches.h[:, rows].clone()
    pool, toks = eng.decode_pool(pool, torch.tensor([ta, 0]), 3)
    assert not torch.equal(pool.caches.h[:, rows], before)
    pool, tc0 = eng.admit(pool, 1, {"tokens": c[None]})
    cur, out = torch.tensor([int(toks[-1, 0]), tc0]), [tc0]
    for _ in range(5):
        pool, toks = eng.decode_pool(pool, cur, 1)
        cur = toks[-1].clone()
        out.append(int(toks[-1, 1]))
    assert out == eng.generate({"tokens": c[None]}, 6)[0].tolist()


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_kv_bytes_per_slot_counts_the_state(name, share):
    """``serve.kv_bytes_per_slot``: a slot's f32 SSM state and conv tails
    (and the hybrid's K/V), each row's int32 position, times the m replica
    rows of the replicated layout; built on the meta device."""
    _, tc, _, tp = _model(name)
    m = 1 if share else 8
    reg = MetricsRegistry()
    ServeEngine(tc, tp, max_len=32, obs=reg, device="cpu",
                robust=RobustDecodeConfig(m=8, share_replica_compute=share))
    s = tc.ssm
    E = s.expand * tc.d_model
    H, GN = E // s.head_dim, 2 * s.n_groups * s.d_state
    state = tc.n_layers * 4 * (H * s.head_dim * s.d_state
                               + (s.d_conv - 1) * (E + GN))
    kv = 0
    if tc.family == "hybrid":
        kv = (tc.n_layers // tc.hybrid_attn_every) * 2 * 32 \
            * tc.n_kv_heads * tc.head_dim * 4
    assert reg.gauges["serve.kv_bytes_per_slot"] == m * (state + kv + 4)
    meta = TC.pool_caches(tc, 3, 32, m=m, device="meta")
    assert meta.h.device.type == "meta" and meta.h.shape[1] == 3 * m
