"""repro_torch's slot pool and continuous-batching scheduler against
``repro``'s.

Both packages serve the reduced qwen3-1.7b in f32 at the same weights
(``convert.params_from_jax``) and the request sets of ``tests/
test_serve.py``'s pool and scheduler cases, passed across as numpy;
``repro`` runs its jitted pool path on the CPU, as its own tests run it.
Greedy ``Completion`` tokens must be exactly equal to ``repro``'s
``Scheduler`` (shared and replicated layouts, none/signflip/gaussian,
f32/bf16/int8 KV; under the gaussian attack the noise streams of the two
frameworks differ, so the tokens held equal are the clean ones) and to
the port's own solo ``generate``. Sampled tokens are compared as
distributions: JAX and torch random streams never match. With 240 draws
a package, a frequency's standard error is at most 0.032, so the total
variation distance of the first token's distribution from the exact
top-3 softmax is held within 0.12 and the two packages' empirical
distributions of each token within 0.15 of each other. The ssm and hybrid
families' pool cases (mamba2, zamba2) are ``test_torch_hybrid.py``'s;
whisper's, each request with its own frames, ``test_torch_whisper.py``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.obs as JO
from repro.configs import get as j_get_arch
from repro.models import model as JM
from repro.serve import Request as JRequest
from repro.serve import RobustDecodeConfig as JRobust
from repro.serve import Sampling as JSampling
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (Request, RobustDecodeConfig, Sampling,
                               Scheduler, ServeEngine, SlotPool)
from repro_torch.serve import cache as TC

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dense():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, repro={})


def _prompt_batch(B, S, seed=1, vocab=512):
    """``test_serve.py``'s ``_prompt_batch`` prompts, as numpy."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                       vocab))


def _rrs(seed, lengths, vocab=512):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, size=(n,)) for n in lengths]


def _j_robust(robust):
    return None if robust is None else JRobust(**robust)


def _t_robust(robust):
    return None if robust is None else RobustDecodeConfig(**robust)


def _serve(st, side, reqs, *, robust=None, block=4, sampling=None, seed=0,
           **eng):
    """Run ``reqs`` ((prompt, max_new_tokens, eos_id) each) through one
    package's Scheduler -> ([tokens], [finished_by], engine) in request
    order."""
    if side == "repro":
        engine = JEngine(st["jcfg"], st["jp"], robust=_j_robust(robust),
                         **eng)
        sched = JScheduler(engine, decode_block=block, seed=seed,
                           sampling=JSampling(*(sampling or ())))
        make = JRequest
    else:
        engine = ServeEngine(st["tcfg"], st["tp"], robust=_t_robust(robust),
                             device="cpu", **eng)
        sched = Scheduler(engine, decode_block=block, seed=seed,
                          sampling=Sampling(*(sampling or ())))
        make = Request
    uids = [sched.submit(make(tokens=p, max_new_tokens=n, eos_id=e))
            for p, n, e in reqs]
    done = sched.run()
    assert sorted(done) == sorted(uids)
    return ([list(map(int, done[u].tokens)) for u in uids],
            [done[u].finished_by for u in uids], engine)


def _repro(st, key, reqs, **kw):
    """repro's completions of one case, computed once a module."""
    if key not in st["repro"]:
        st["repro"][key] = _serve(st, "repro", reqs, **kw)[:2]
    return st["repro"][key]


def _solo(engine, prompt, n):
    return engine.generate({"tokens": np.asarray(prompt)[None]}, n)[0] \
        .tolist()


# -- test_serve.py's scheduler cases -----------------------------------------

def test_pool_variable_length_admission(dense):
    """Prompts of 5, 17 and 11 tokens through 3 slots: repro's completions
    and each request's solo decode, exactly."""
    reqs = [(p, 7, None) for p in _rrs(0, (5, 17, 11))]
    kw = dict(max_len=64, n_slots=3, block=4)
    toks, by, eng = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, "variable", reqs, **kw)
    assert by == ["length"] * 3
    for (p, n, _), t in zip(reqs, toks):
        assert t == _solo(eng, p, n)


def test_pool_slot_reuse_after_retirement(dense):
    """Two slots: the third request waits for the short one to retire,
    then decodes beside the long one, which it leaves unchanged."""
    short, long, late = _rrs(1, (6, 9, 4))
    reqs = [(short, 2, None), (long, 12, None), (late, 8, None)]
    kw = dict(max_len=64, n_slots=2, block=2)
    toks, by, eng = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, "reuse", reqs, **kw)
    for (p, n, _), t in zip(reqs, toks):
        assert len(t) == n and t == _solo(eng, p, n)


def test_pool_queue_starvation(dense):
    """Seven requests, two slots: FIFO admission drains the queue."""
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 512, size=(4 + i,)), 3, None) for i in range(7)]
    kw = dict(max_len=48, n_slots=2, block=3)
    toks, by, _ = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, "starvation", reqs, **kw)
    assert all(len(t) == 3 for t in toks)


def test_pool_rejects_oversized_requests(dense):
    """A request whose prompt + budget + block overshoot cannot fit a slot
    is rejected onto the completions, and the queue behind it drains."""
    big, tight, ok = _rrs(4, (40, 10, 10))
    reqs = [(big, 4, None), (tight, 20, None), (ok, 4, None)]
    kw = dict(max_len=24, n_slots=1, block=2)
    toks, by, _ = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, "reject", reqs, **kw)
    assert by == ["rejected", "rejected", "length"]
    assert toks[0] == [] and len(toks[2]) == 4


def test_pool_eos_trims_overshoot(dense):
    """EOS mid-block stops the sequence; overshoot tokens are trimmed."""
    prompt = _prompt_batch(1, 8, seed=9)[0]
    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=48, n_slots=1,
                      device="cpu")
    probe = _solo(eng, prompt, 8)
    reqs = [(prompt, 8, probe[2])]
    kw = dict(max_len=48, n_slots=1, block=8)
    toks, by, _ = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, "eos", reqs, **kw)
    assert by == ["eos"] and toks[0] == probe[:3]


ROBUST = dict(m=4, estimator="vrmom", K=8, alpha=0.25)


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("attack", ["signflip", "gaussian"])
def test_robust_pool_under_attack_equals_clean(dense, attack, share):
    """Replicated decode through the pool, across mid-decode admissions:
    completions equal the plain pool's and repro's robust pool's (repro's
    signflip run: its tokens are the clean ones, as the contract says)."""
    reqs = [(p, 6, None) for p in _rrs(7, (5, 7, 9))]
    kw = dict(max_len=64, n_slots=2, block=3)
    robust = dict(ROBUST, attack=attack, share_replica_compute=share)
    toks, by, _ = _serve(dense, "port", reqs, robust=robust, **kw)
    plain, _, _ = _serve(dense, "port", reqs, **kw)
    want = _repro(dense, "robust", reqs, robust=dict(ROBUST, attack=
                                                     "signflip"), **kw)
    assert toks == plain
    assert (toks, by) == want


def test_shared_vs_replicated_pool_identity(dense):
    """Plain-shaped robust slots decode the tokens the m-row replicated
    pool does, and repro's shared pool's."""
    prompts = _prompt_batch(2, 10)
    reqs = [(p, 5, None) for p in prompts]
    kw = dict(max_len=24, n_slots=2, block=3)
    out = {}
    for share in (True, False):
        robust = dict(ROBUST, attack="signflip", share_replica_compute=share)
        out[share], _, eng = _serve(dense, "port", reqs, robust=robust, **kw)
        assert eng.make_pool().caches.k.shape[1] == (2 if share else 8)
    assert out[True] == out[False]
    want = _repro(dense, "layouts", reqs,
                  robust=dict(ROBUST, attack="signflip"), **kw)[0]
    assert out[True] == want


@pytest.mark.parametrize("kv", [None, "bfloat16", "int8"])
def test_pool_quantized_kv(dense, kv):
    """Mixed-length requests through a pool of f32, bf16 or int8 KV:
    repro's completions at the same KV dtype, exactly."""
    batch = _prompt_batch(3, 10)
    reqs = [(batch[i][:6 + i], 5, None) for i in range(3)]
    kw = dict(max_len=24, n_slots=3, kv_dtype=kv)
    toks, by, _ = _serve(dense, "port", reqs, **kw)
    assert (toks, by) == _repro(dense, ("kv", kv), reqs, **kw)


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_kv_bytes_per_slot_gauge(dense, share):
    """serve.kv_bytes_per_slot: bf16 halves the f32 bytes, int8 (data and
    f32 scales) is under 0.35x; the replicated layout counts m rows. The
    bytes are the K/V (and scale) bytes ``repro``'s gauge counts, plus one
    int32 position a row where ``repro`` keeps one a layer. The caches are
    built on the meta device: the gauge allocates nothing."""
    tcfg = dense["tcfg"]
    robust = RobustDecodeConfig(**ROBUST, share_replica_compute=share)
    m = 1 if share else ROBUST["m"]
    g = {}
    for kv in (None, "bfloat16", "int8"):
        reg = MetricsRegistry()
        ServeEngine(tcfg, dense["tp"], max_len=32, kv_dtype=kv, obs=reg,
                    robust=robust, device="cpu")
        g[kv] = reg.snapshot()["gauges"]["serve.kv_bytes_per_slot"]
        jreg = JO.MetricsRegistry()
        JEngine(dense["jcfg"], dense["jp"], max_len=32, kv_dtype=kv,
                obs=jreg, robust=JRobust(**ROBUST,
                                         share_replica_compute=share))
        want = jreg.gauges["serve.kv_bytes_per_slot"]
        assert g[kv] == want - 4 * m * (tcfg.n_layers - 1)
    kv_f32 = g[None] - 4 * m
    assert abs((g["bfloat16"] - 4 * m) / kv_f32 - 0.5) < 0.05
    assert g["int8"] < 0.35 * g[None]
    assert g[None] == m * (2 * tcfg.n_layers * 32 * tcfg.n_kv_heads
                           * tcfg.head_dim * 4 + 4)
    meta = TC.pool_caches(tcfg, 3, 32, m=m, device="meta")
    assert meta.k.device.type == "meta"
    assert TC.kv_bytes_per_slot(
        lambda n: TC.pool_caches(tcfg, n, 32, m=m, device="meta"), 3) \
        == g[None]


# -- the port's pool: in-place writes and idle slots -------------------------

@pytest.mark.parametrize("kv", [None, "int8"])
def test_write_slot_in_place_every_replica_row(dense, kv):
    """``write_slot`` copies a batch-1 cache into every replica row of the
    slot, in the pool's own tensors, and resets each row's position;
    ``evict_slot`` clears the bookkeeping only."""
    tcfg = dataclasses.replace(dense["tcfg"], kv_dtype=kv)
    m, n = 3, 4
    pool = TC.init_pool(tcfg, n, 16, m=m, device="cpu")
    pool.caches.pos.fill_(99)  # positions left by a long idle stretch
    ptrs = [x.data_ptr() for x in pool.caches if x is not None]
    from repro_torch.models import model as TM
    _, req = TM.prefill(dense["tp"], tcfg,
                        {"tokens": torch.from_numpy(_rrs(3, (6,))[0])[None]},
                        cache_len=16)
    assert TC.write_slot(pool, req, 2, 6) is pool
    assert [x.data_ptr() for x in pool.caches if x is not None] == ptrs
    assert pool.caches.pos.view(m, n)[:, 2].tolist() == [6] * m
    assert pool.caches.pos.view(m, n)[:, 1].tolist() == [99] * m
    for f in ("k", "v", "k_scale", "v_scale"):
        x = getattr(pool.caches, f)
        if x is None:
            continue
        rows = x.view((x.shape[0], m, n) + x.shape[2:])
        for r in range(m):
            assert torch.equal(rows[:, r, 2], getattr(req, f)[:, 0])
        assert rows[:, :, 1].abs().sum() == 0
    assert pool.lengths.tolist() == [0, 0, 6, 0]
    assert pool.active.tolist() == [False, False, True, False]
    TC.evict_slot(pool, 2)
    assert pool.lengths.tolist() == [0] * 4 and not pool.active.any()
    assert torch.equal(pool.caches.pos.view(m, n)[:, 2],
                       torch.full((m,), 6, dtype=torch.int32))


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
def test_idle_slot_neither_overruns_nor_leaks(dense, share):
    """A free slot decodes on with the others and its positions run far
    past the cache (the linear cache clamps its write slot, attention
    reads min(pos + 1, T)); admitted afterwards, it serves the solo
    tokens, as does a slot reused after eviction; lengths advance only
    where active."""
    robust = None if share else dict(ROBUST, attack="signflip",
                                     share_replica_compute=False)
    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=24, n_slots=2,
                      robust=_t_robust(robust), device="cpu")
    pool = eng.make_pool()
    a, b = _rrs(11, (7, 9))
    pool, first = eng.admit(pool, 0, {"tokens": a[None]})
    cur = np.asarray([first, 0], np.int32)
    for _ in range(10):  # slot 1 idle for 40 steps, T = 24
        pool, toks = eng.decode_pool(pool, cur, 4)
        cur = toks[-1].numpy()
    assert int(pool.caches.pos.view(-1, 2)[0, 1]) == 40
    assert pool.lengths.tolist() == [7 + 40, 0]
    eng.evict(pool, 0)
    got = {}
    for slot, p in ((1, b), (0, a)):
        pool, got[slot] = eng.admit(pool, slot, {"tokens": p[None]})
    cur = np.asarray([got[0], got[1]], np.int32)
    seqs = {0: [got[0]], 1: [got[1]]}
    for _ in range(2):
        pool, toks = eng.decode_pool(pool, cur, 3)
        cur = toks[-1].numpy()
        for s in (0, 1):
            seqs[s] += toks[:, s].tolist()
    assert pool.lengths.tolist() == [7 + 6, 9 + 6]
    assert seqs[0] == _solo(eng, a, 7)
    assert seqs[1] == _solo(eng, b, 7)


def test_decode_pool_follows_its_pool(dense):
    """The step buffers are bound to one pool's tensors; decoding another
    pool rebinds them (and would drop the steps captured over the old
    one), and each pool keeps its own rows."""
    eng = ServeEngine(dense["tcfg"], dense["tp"], max_len=24, n_slots=2,
                      device="cpu")
    p1, p2 = eng.make_pool(), eng.make_pool()
    a, b = _rrs(12, (6, 8))
    p1, f1 = eng.admit(p1, 0, {"tokens": a[None]})
    p2, f2 = eng.admit(p2, 1, {"tokens": b[None]})
    p1, t1 = eng.decode_pool(p1, [f1, 0], 4)
    assert eng.pool_buffers.caches.k is p1.caches.k
    p2, t2 = eng.decode_pool(p2, [0, f2], 4)
    assert eng.pool_buffers.caches.k is p2.caches.k
    assert isinstance(p1, SlotPool) and p1.lengths.tolist() == [10, 0]
    assert [f1] + t1[:, 0].tolist() == _solo(eng, a, 5)
    assert [f2] + t2[:, 1].tolist() == _solo(eng, b, 5)


# -- sampled tokens, as distributions ----------------------------------------

def _tv(a, b, support):
    pa = np.asarray([np.mean(np.asarray(a) == s) for s in support])
    pb = np.asarray([np.mean(np.asarray(b) == s) for s in support])
    return 0.5 * float(np.abs(pa - pb).sum())


def test_sampled_pool_matches_repro_in_distribution(dense):
    """Top-3 sampling through the pool: 240 requests of one prompt, two
    tokens each, in both packages. The first token's distribution is the
    top-3 softmax of the prefill logits (repro's), and the packages'
    empirical distributions of each token agree."""
    prompt = _rrs(5, (6,))[0]
    reqs = [(prompt, 2, None)] * 240
    kw = dict(max_len=16, n_slots=8, block=1, sampling=("top_k", 1.0, 3))
    port, _, _ = _serve(dense, "port", reqs, seed=1, **kw)
    repro, _ = _repro(dense, "sampled", reqs, seed=1, **kw)
    logits, _ = JEngine(dense["jcfg"], dense["jp"], max_len=16).prefill(
        {"tokens": prompt[None]})
    lg = np.asarray(logits[0], np.float64)
    top = np.argsort(-lg)[:3]
    p = np.exp(lg[top] - lg[top].max())
    p /= p.sum()
    first = [t[0] for t in port]
    assert set(first) <= set(top.tolist())
    emp = np.asarray([np.mean(np.asarray(first) == s) for s in top])
    assert 0.5 * float(np.abs(emp - p).sum()) <= 0.12
    for i in range(2):
        a, b = [t[i] for t in port], [t[i] for t in repro]
        assert _tv(a, b, sorted(set(a) | set(b))) <= 0.15
