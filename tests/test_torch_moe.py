"""repro_torch's mixture of experts (the moe family) against ``repro``.

granite-moe-3b-a800m and mixtral-8x7b at their ``reduced()`` sizes (4
experts, top-2; mixtral with a window of 16), and variants at granite's
own 40 experts and top-8 with narrow widths. ``repro``'s seeded params go
through ``convert.params_from_jax`` (or its ``moe_init`` leaves as they
are), and the inputs are numpy. Tolerances: 1e-5 on ``moe_ffn``'s output
and load-balance loss in f32 (sums in another order); 1e-4 on f32 logits
and on the loss and its gradients (as the dense models'); routing
decisions (expert, position in the expert, kept) exact, in f32 and in
bf16, where the router's logits tie often; greedy tokens exact. The
routing of ``repro`` is read off its own lines (``_j_route`` repeats
``repro/models/moe.py:36-66``, which returns only the combined output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoE
from repro.configs import get as j_get_arch
from repro.models import model as JM
from repro.models import moe as JX
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import MoEConfig as TMoE
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import expected_shapes, params_from_jax
from repro_torch.data import lm_batch
from repro_torch.models import model as TM
from repro_torch.models import moe as TX
from repro_torch.serve import (Request, RobustDecodeConfig, Scheduler,
                               ServeEngine)
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

NAMES = ["granite-moe-3b-a800m", "mixtral-8x7b"]
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))
_MODELS = {}


def _cfgs(name, moe=None, **kw):
    """(repro's config, the port's), reduced, with ``moe`` = (n_experts,
    top_k, capacity_factor) and other fields replaced."""
    jc, tc = j_get_arch(name).reduced(), t_get_arch(name).reduced()
    if moe is not None:
        kw_j, kw_t = dict(kw, moe=JMoE(*moe)), dict(kw, moe=TMoE(*moe))
    else:
        kw_j = kw_t = kw
    return dataclasses.replace(jc, **kw_j), dataclasses.replace(tc, **kw_t)


def _model(name, moe=None, **kw):
    """(repro's config, the port's, repro's params, the port's), cached."""
    key = (name, moe, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jc, tc = _cfgs(name, moe, **kw)
        jp = JM.init(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _experts(jc, seed=3):
    """``repro``'s ``moe_init`` leaves, in repro's arrays and as torch."""
    p = JX.moe_init(jax.random.PRNGKey(seed), jc)
    return p, {k: _torch(np.asarray(v)) for k, v in p.items()}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _x(shape, dtype=np.float32, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x.astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _j_route(p, x, cfg):
    """``repro``'s routing decisions for one group x [T, D]: its lines
    ``moe.py:36-66`` up to the one-hot dispatch -> (expert [T, k], pos
    [T, k], keep [T, k]) as numpy."""
    m = cfg.moe
    T = x.shape[0]
    E, k = m.n_experts, m.top_k
    C = max(int(m.capacity_factor * k * T / E), 1)
    logits = jnp.einsum("td,de->te", x, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    counts = jnp.zeros((E,), jnp.int32)
    poss, keeps = [], []
    for slot in range(k):
        e = idx[:, slot]
        onehot = jax.nn.one_hot(e, E, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=0) - 1
        pos = jnp.take_along_axis(pos, e[:, None], axis=1)[:, 0] + counts[e]
        poss.append(pos)
        keeps.append(pos < C)
        counts = counts + jnp.sum(onehot, axis=0)
    return (np.asarray(idx), np.stack([np.asarray(a) for a in poss], 1),
            np.stack([np.asarray(a) for a in keeps], 1))


def _routing_equal(jp, tp, x, jc, tc):
    """Every group of x [B, T, D]: the port's routing is repro's, exactly.
    Returns the share of (token, slot) pairs dropped."""
    dropped = 0
    for b in range(x.shape[0]):
        want = _j_route(jp, jnp.asarray(x[b]), jc)
        r = TX.route(_torch(x[b])[None], tp["router"], tc)
        got = (r.expert[0].numpy(), r.pos[0].numpy(), r.keep[0].numpy())
        for w, g, what in zip(want, got, ("expert", "pos", "keep")):
            np.testing.assert_array_equal(g, w, err_msg=what)
        dropped += int((~got[2]).sum())
    return dropped / (x.shape[0] * x.shape[1] * tc.moe.top_k)


def _ffn_equal(jp, tp, x, jc, tc, tol=1e-5):
    y, aux = JX.moe_ffn(jp, jnp.asarray(x), jc)
    ty, taux = TX.moe_ffn(tp, _torch(x), tc)
    assert ty.shape == tuple(y.shape) and taux.shape == ()
    _close(ty, y, tol)
    _close(taux, aux, tol)
    return ty


# -- moe_ffn and the routing -------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_matches_repro_f32(name):
    """Reduced (4 experts, top-2, capacity 1.25): y and the aux loss within
    1e-5, every routing decision exact."""
    jc, tc = _cfgs(name)
    jp, tp = _experts(jc)
    x = _x((3, 16, jc.d_model))
    _ffn_equal(jp, tp, x, jc, tc)
    _routing_equal(jp, tp, x, jc, tc)


@pytest.mark.parametrize("name,moe", [
    ("granite-moe-3b-a800m", None), ("mixtral-8x7b", None),
    ("granite-moe-3b-a800m", (40, 8, 1.25))], ids=["granite", "mixtral",
                                                   "granite-E40"])
def test_routing_matches_repro_bf16(name, moe):
    """bf16 params and input: the router's product stays in bf16 before
    the f32 softmax, its logits tie often, and the port picks repro's
    experts, positions and kept slots, exactly; y within bf16 rounding."""
    jc, tc = _cfgs(name, moe, param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    jp, tp = _experts(jc)
    x = _x((4, 24, jc.d_model), ml_dtypes.bfloat16, seed=1)
    _routing_equal(jp, tp, x, jc, tc)
    y, _ = JX.moe_ffn(jp, jnp.asarray(x), jc)
    ty, _ = TX.moe_ffn(tp, _torch(x), tc)
    assert ty.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(y, np.float32)).max())
    _close(ty.float() / scale, np.asarray(y, np.float32) / scale, 3e-2)


def test_moe_ffn_at_granite_experts_and_top_k():
    """granite's own 40 experts and top-8 at narrow widths (D 64, F 32): the
    position carry over 8 slots, and capacity C = 4 at T = 16 binding."""
    jc, tc = _cfgs("granite-moe-3b-a800m", (40, 8, 1.25), d_model=64,
                   d_ff=32)
    jp, tp = _experts(jc)
    x = _x((3, 16, 64), seed=2)
    _ffn_equal(jp, tp, x, jc, tc)
    assert 0 < _routing_equal(jp, tp, x, jc, tc) < 1


@pytest.mark.parametrize("name", NAMES)
def test_capacity_binding(name):
    """capacity_factor 0.25: C = max(int(0.25 * 2 * 16 / 4), 1) = 2 of the
    8 rows a perfectly balanced expert would need; many slots drop, and
    a dropped slot adds nothing."""
    jc, tc = _cfgs(name, (4, 2, 0.25))
    jp, tp = _experts(jc)
    x = _x((2, 16, jc.d_model), seed=4)
    assert TX.capacity(tc, 16) == 2
    _ffn_equal(jp, tp, x, jc, tc)
    assert _routing_equal(jp, tp, x, jc, tc) > 0.5


@pytest.mark.parametrize("E,k", [(4, 2), (40, 8)])
def test_router_ties_take_the_lower_index(E, k):
    """Router columns made equal in runs, so that whole runs of experts tie
    and a tie straddles the top-k boundary: repro's top_k (and the port's)
    takes the lower expert index first. With every column equal the top-k
    is experts 0..k-1."""
    jc, tc = _cfgs("granite-moe-3b-a800m", (E, k, 1.25), d_model=64,
                   d_ff=32)
    jp, tp = _experts(jc)
    router = np.asarray(jp["router"]).copy()
    for e in range(E):
        router[:, e] = router[:, 1 + (e - 1) // 3 * 3] if e else router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _x((2, 16, 64), seed=5)
    _ffn_equal(jp, tp, x, jc, tc)
    _routing_equal(jp, tp, x, jc, tc)
    flat = np.repeat(router[:, :1], E, axis=1)
    r = TX.route(_torch(x[:1]), torch.from_numpy(flat), tc)
    assert (r.expert[0] == torch.arange(k)).all()
    want, _, _ = _j_route(dict(jp, router=jnp.asarray(flat)),
                          jnp.asarray(x[0]), jc)
    assert (want == np.arange(k)).all()


@pytest.mark.parametrize("S,groups", [(4096, 2), (2050, 1)])
def test_sequence_groups(S, groups):
    """A row of 4096 tokens routes as two groups of 2048 (MOE_SEQ_CHUNK); a
    row of 2050 is not a multiple of 2048 and routes as one group."""
    jc, tc = _cfgs("mixtral-8x7b", d_model=32, d_ff=16)
    jp, tp = _experts(jc)
    x = _x((1, S, 32), seed=6)
    _ffn_equal(jp, tp, x, jc, tc)
    T = S // groups
    assert TX.capacity(tc, T) == int(1.25 * 2 * T / 4)
    for g in range(groups):
        _routing_equal(jp, tp, x[:, g * T:(g + 1) * T], jc, tc)


# -- the model: prefill, decode, loss ----------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_teacher_forced_decode_match(name):
    """Prefill logits and caches, then 6 decode steps fed the same tokens:
    1e-4 on f32. mixtral's prompt of 20 passes its window of 16, so the
    prefill masks by the window, keeps a ring of 16 slots and the decode
    wraps it."""
    jc, tc, jp, tp = _model(name)
    S = 20 if tc.sliding_window else 12
    toks = np.random.RandomState(1).randint(0, tc.vocab, size=(2, S))
    feed = np.random.RandomState(2).randint(0, tc.vocab, size=(2, 6))
    jl, jcache = _j_prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                            cache_len=24)
    tl, tcache = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)},
                            cache_len=24)
    _close(tl, jl, 1e-4)
    assert tuple(tcache.k.shape) == jcache.k.shape
    assert tcache.k.shape[2] == (16 if tc.sliding_window else 24)
    for s in range(feed.shape[1]):
        jl, jcache = _j_decode(jp, jc, jcache,
                               jnp.asarray(feed[:, s], jnp.int32))
        tl, tcache = TM.decode_step(tp, tc, tcache,
                                    torch.from_numpy(feed[:, s]))
        _close(tl, jl, 1e-4)
    _close(tcache.k, jcache.k, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_consistency(name):
    """``repro``'s own check (tests/test_models.py:95-128) on the port: with
    capacity_factor = E nothing drops, and decoding the last token after a
    prefill of the others gives the full prefill's last logits (2e-3)."""
    _, tc = _cfgs(name, (4, 2, 4.0))
    params = TM.init(tc, torch.Generator().manual_seed(7), device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(8))
    full, _ = TM.prefill(params, tc, {"tokens": toks})
    _, caches = TM.prefill(params, tc, {"tokens": toks[:, :-1]},
                           cache_len=28)
    dec, _ = TM.decode_step(params, tc, caches, toks[:, -1])
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_repro(name):
    """``model.loss`` (0.01 x the load-balance loss included) and its
    gradients against ``jax.value_and_grad(repro.models.model.loss)``,
    1e-4, on a batch whose groups drop slots; the aux term alone at
    1e-5."""
    jc, tc, jp, tp = _model(name)
    toks = np.random.RandomState(3).randint(0, tc.vocab, size=(2, 24))
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss(p, jc, {"tokens": jnp.asarray(toks)}))(jp)
    tp = _clone(tp)
    leaves = list(_leaves(tp))
    for v in leaves:
        v.requires_grad_(True)
    tl = TM.loss(tp, tc, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    _close(tl.detach(), jl, 1e-4)
    for (path, a), b in zip(_j_leaves(jg), leaves):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    _, _, jaux = JM.transformer.forward(jp, jc, {"tokens": jnp.asarray(toks)},
                                        return_hidden=True)
    with torch.no_grad():
        _, _, taux = TM.transformer.forward(
            tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(taux, jaux, 1e-5)
    assert float(taux) > 0


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _leaves(tree):
    """The port's param leaves in sorted-key order (JAX's leaf order)."""
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _j_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _j_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_train_step_takes_a_step():
    """One stacked VRMOM step of ``make_train_step`` on the reduced granite
    on the CPU: a finite loss, and every expert leaf moved."""
    _, tc, _, tp = _model("granite-moe-3b-a800m")
    before = tp["layers"]["moe"]
    tp = _clone(tp)
    setup = make_train_step(tc, 4, estimator="vrmom", lr=1e-2, device="cpu")
    opt = setup.optimizer.init(tp)
    tp, opt, loss = setup.step_fn(tp, opt, lm_batch(tc, 0, 8, 24,
                                                    device="cpu"))
    assert np.isfinite(float(loss))
    for k, v in tp["layers"]["moe"].items():
        assert torch.isfinite(v).all() and not torch.equal(v, before[k]), k


def test_shapes_and_active_params():
    """The port's seeded init has repro's shapes (and ``expected_shapes``'),
    and ``active_param_count`` counts as repro's does."""
    for name in NAMES:
        jc, tc = _cfgs(name)
        tp = TM.init(tc, torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.eval_shape(lambda k: JM.init(k, jc),
                                 jax.random.PRNGKey(0))
        got = {p: tuple(v.shape) for p, v in zip(
            (p for p, _ in _j_leaves(tp)), _leaves(tp))}
        want = {p: tuple(v.shape) for p, v in _j_leaves(jshapes)}
        shapes = {p: tuple(v) for p, v in _j_leaves(expected_shapes(tc))}
        assert got == want == shapes
        jp = _model(name)[2]
        assert TM.active_param_count(_model(name)[3], tc) \
            == JM.active_param_count(jp, jc) < TM.param_count(tp)
        router = tp["layers"]["moe"]["router"]
        assert abs(float(router.std()) - tc.d_model ** -0.5) < 0.01


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_match_repro(name):
    """``ServeEngine.generate`` on both sides: greedy tokens exact. mixtral's
    prompt of 14 and 8 new tokens run its ring of 16 past its end."""
    jc, tc, jp, tp = _model(name)
    toks = np.random.RandomState(4).randint(0, tc.vocab, size=(2, 14))
    want = np.asarray(JEngine(jc, jp, max_len=22).generate(
        {"tokens": jnp.asarray(toks)}, 8))
    got = ServeEngine(tc, tp, max_len=22, device="cpu").generate(
        {"tokens": toks}, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("share", [True, False], ids=["shared",
                                                      "replicated"])
@pytest.mark.parametrize("attack", ["signflip", "gaussian"])
def test_robust_greedy_under_attack_equals_clean(attack, share):
    """Reduced granite, robust m = 8 VRMOM at alpha 0.25, fused and
    unfused: the tokens under attack are the clean tokens, in both
    layouts (repro's robustness contract)."""
    _, tc, _, tp = _model("granite-moe-3b-a800m")
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


def _reqs(seed, n, vocab):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, size=(int(rs.randint(4, 17)),)),
             int(rs.randint(3, 9))) for _ in range(n)]


def test_pool_equals_solo_and_repro():
    """Reduced granite through ``Scheduler`` over 3 slots (robust m = 8
    under signflip): every completion equals the request's solo
    ``generate`` and ``repro``'s Scheduler's, exactly."""
    jc, tc, jp, tp = _model("granite-moe-3b-a800m")
    reqs = _reqs(6, 6, tc.vocab)
    robust = RobustDecodeConfig(m=8, attack="signflip")
    eng = ServeEngine(tc, tp, max_len=32, n_slots=3, robust=robust,
                      device="cpu")
    sched = Scheduler(eng, decode_block=3)
    uids = [sched.submit(Request(tokens=p, max_new_tokens=n))
            for p, n in reqs]
    done = sched.run()
    got = [list(map(int, done[u].tokens)) for u in uids]
    jeng = JEngine(jc, jp, max_len=32, n_slots=3)
    jsched = JScheduler(jeng, decode_block=3)
    juids = [jsched.submit(JRequest(tokens=p, max_new_tokens=n))
             for p, n in reqs]
    jdone = jsched.run()
    assert got == [list(map(int, jdone[u].tokens)) for u in juids]
    for (p, n), t in zip(reqs, got):
        assert t == eng.generate({"tokens": p[None]}, n)[0].tolist()


def test_windowed_pool_below_the_window_pinned():
    """A windowed pool whose max_len (12) is below the window (16): repro
    sizes the pool's ring at min(window, max_len) = 12 slots while its
    prefill makes 16, so its first admission raises; the port's pool holds
    the 16 slots the prefill makes and serves, each completion equal to
    the request's solo generate and to repro's generate (ROADMAP.md §C)."""
    jc, tc, jp, tp = _model("mixtral-8x7b")
    reqs = _reqs(7, 3, tc.vocab)
    reqs = [(p[:5], 4) for p, _ in reqs]
    jsched = JScheduler(JEngine(jc, jp, max_len=12, n_slots=2),
                        decode_block=2)
    jsched.submit(JRequest(tokens=reqs[0][0], max_new_tokens=4))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jsched.run()
    assert jsched.pool.caches.k.shape[2] == 12
    eng = ServeEngine(tc, tp, max_len=12, n_slots=2, device="cpu")
    sched = Scheduler(eng, decode_block=2)
    uids = [sched.submit(Request(tokens=p, max_new_tokens=n))
            for p, n in reqs]
    done = sched.run()
    assert sched.pool.caches.k.shape[2] == 16
    assert all(done[u].finished_by == "length" for u in uids)
    for u, (p, n) in zip(uids, reqs):
        want = np.asarray(JEngine(jc, jp, max_len=12).generate(
            {"tokens": jnp.asarray(p[None])}, n))[0].tolist()
        assert list(map(int, done[u].tokens)) == want \
            == eng.generate({"tokens": p[None]}, n)[0].tolist()
