"""repro_torch's encoder-decoder (whisper) family against ``repro``.

Both packages run whisper-medium at its ``reduced()`` size (2 encoder and
2 decoder layers, d_model 128, 4 heads of 32 over 2 kv heads, 12 stub
frames) in f32 at the same weights (``convert.params_from_jax``); tokens
and frames are made with numpy. Tolerances: 1e-4 on f32 encoder outputs,
logits, caches, the loss and its gradients (``test_torch_models.py``'s);
greedy tokens exact: ``generate`` against ``repro``'s
``ServeEngine.generate``, robust greedy under signflip and gaussian
against the clean tokens (shared and replicated, fused and unfused), the
flash backend against the torch one, ``generate`` against
``generate_python_loop``, and the pool (each request with its own frames)
against each request's solo ``generate`` and against ``repro``'s
``Scheduler`` on ``tests/test_serve.py:170-194``'s request set. Under
gaussian the two frameworks' noise streams differ, so the tokens held
equal are the clean ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.data import lm_batch as j_lm_batch
from repro.models import model as JM
from repro.models import whisper as JW
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import expected_shapes, params_from_jax
from repro_torch.data import lm_batch
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import whisper as TW
from repro_torch.models.layers import sinusoid, sinusoidal_positions
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (Request, RobustDecodeConfig, Scheduler,
                               ServeEngine)
from repro_torch.serve import cache as TC

torch.set_num_threads(1)

NAME = "whisper-medium"
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))
_MODELS = {}


def _model(**kw):
    """(repro's config, the port's, repro's params, the port's), reduced
    with ``kw`` replaced, cached."""
    key = tuple(sorted(kw.items()))
    if key not in _MODELS:
        jc = dataclasses.replace(j_get_arch(NAME).reduced(), **kw)
        tc = dataclasses.replace(t_get_arch(NAME).reduced(), **kw)
        jp = JM.init(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _batch(cfg, B, S, seed):
    """numpy tokens [B, S] and frames [B, F, D] f32."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, cfg.vocab, size=(B, S)),
            "frames": rs.randn(B, cfg.encoder.n_frames,
                               cfg.d_model).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order (JAX's leaf order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# -- config, shapes, data ----------------------------------------------------

def test_config_matches_repro():
    """whisper-medium comes from the registry with ``repro``'s fields and
    encoder, and ``reduced()`` cuts both the same way (2 encoder layers over
    12 frames)."""
    jc, tc = j_get_arch(NAME), t_get_arch(NAME)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "d_head", "rope", "tie_embeddings",
              "sliding_window", "source"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert dataclasses.asdict(tc.encoder) == dataclasses.asdict(jc.encoder)
    assert (tc.encoder.n_layers, tc.encoder.n_frames) == (24, 1500)
    rj, rt = jc.reduced(), tc.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "compute_dtype"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert dataclasses.asdict(rt.encoder) == dataclasses.asdict(rj.encoder)


def test_expected_shapes_match_repro_at_full_width():
    """``convert``'s shapes of whisper-medium at full width are those of
    repro's init (traced, nothing allocated): the encoder and decoder
    stacks, self and cross attention, the tied embedding."""
    jc, tc = j_get_arch(NAME), t_get_arch(NAME)
    shapes = jax.eval_shape(lambda k: JM.init(k, jc), jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in _leaves(shapes)}
    got = dict(_leaves(expected_shapes(tc)))
    assert got == want
    assert got["dec_layers/cross/wk"] == (24, 1024, 16, 64)
    assert got["enc_layers/mlp/w_gate"] == (24, 1024, 4096)
    assert sum(int(np.prod(s)) for s in got.values()) == 959_204_352


def test_params_round_trip_and_shape_check():
    """``params_from_jax`` copies repro's tree exactly and refuses a leaf
    of the wrong shape or a missing one."""
    _, tc, jp, tp = _model()
    for path, v in _leaves(tp):
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(dict(_leaves(jp))[path]), err_msg=path)
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, dec_layers=dict(
        tree["dec_layers"], cross=dict(tree["dec_layers"]["cross"],
                                       wk=tree["dec_layers"]["cross"]["wq"][
                                           :, :, :1])))
    with pytest.raises(ValueError, match="dec_layers/cross/wk"):
        params_from_jax(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "norm_enc"},
                        tc, device="cpu")


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_lm_batch_frames_bitwise(full):
    """``lm_batch`` gives ``repro``'s tokens and stub frames [B, F, D] bit
    for bit (f32 reduced, bf16 at full width)."""
    jc, tc = j_get_arch(NAME), t_get_arch(NAME)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    jb = j_lm_batch(jc, 3, 2, 16, 5)
    tb = lm_batch(tc, 3, 2, 16, 5, device="cpu")
    assert sorted(jb) == sorted(tb) == ["frames", "tokens"]
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    got, want = tb["frames"], np.asarray(jb["frames"])
    assert tuple(got.shape) == (2, tc.encoder.n_frames, tc.d_model)
    if full:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(12, 128), (1500, 1024), (7, 32)])
def test_sinusoidal_positions_match_repro(n, d):
    """``sinusoidal_positions`` against ``repro``'s in f32, and the decode
    step's per-row ``sinusoid`` at positions p equal, bit for bit, to row p
    of the table the prefill adds. Tolerance: twice an f32 ulp of the angle
    at the last position (the two frameworks' ``exp`` may part in the last
    bit of a frequency, which the position multiplies): 2.5e-4 at 1499,
    below 2e-6 at 11."""
    table = sinusoidal_positions(n, d)
    tol = 2.0 * float(np.spacing(np.float32(n - 1)))
    np.testing.assert_allclose(table.numpy(), np.asarray(j_sinusoidal(n, d)),
                               rtol=0, atol=tol)
    pos = torch.tensor([0, n - 1, n // 2], dtype=torch.int32)
    assert torch.equal(sinusoid(pos, d), table[pos.long()])
    assert sinusoidal_positions(n, d, torch.bfloat16).dtype == torch.bfloat16


def test_encode_matches_repro():
    """The encoder (non-causal self-attention over 12 frames and their
    sinusoids, 2 layers, ``norm_enc``) within 1e-4."""
    jc, tc, jp, tp = _model()
    b = _batch(tc, 3, 5, 0)
    _close(TW.encode(tp, tc, torch.from_numpy(b["frames"])),
           JW.encode(jp, jc, jnp.asarray(b["frames"])), 1e-4)


@pytest.mark.parametrize("S", [9, 21], ids=["one-chunk", "two-chunks"])
def test_prefill_and_teacher_forced_decode_match(S):
    """The full forward's logits, the prefill's caches (self K/V padded to
    30 slots, cross K/V over the 12 frames) and 6 decode steps fed the same
    tokens, within 1e-4."""
    jc, tc, jp, tp = _model()
    b = _batch(tc, 2, S, 1)
    feed = np.random.RandomState(2).randint(0, tc.vocab, size=(2, 6))
    jl, jcache = _j_prefill(jp, jc, _j(b), cache_len=30)
    tl, tcache = TM.prefill(tp, tc, _t(b), cache_len=30)
    assert isinstance(tcache, TW.EncDecCache)
    assert tuple(tcache.k.shape) == (2, 2, 30, 2, 32)
    assert tuple(tcache.ck.shape) == (2, 2, 12, 2, 32)
    assert tcache.pos.tolist() == [S, S]
    _close(tl, jl, 1e-4)
    _close(tcache.k, jcache.self_kv.k, 1e-4)
    _close(tcache.v, jcache.self_kv.v, 1e-4)
    _close(tcache.ck, jcache.cross_kv.k, 1e-4)
    _close(tcache.cv, jcache.cross_kv.v, 1e-4)
    for s in range(feed.shape[1]):
        jl, jcache = _j_decode(jp, jc, jcache,
                               jnp.asarray(feed[:, s], jnp.int32))
        tl, tcache = TM.decode_step(tp, tc, tcache,
                                    torch.from_numpy(feed[:, s]))
        _close(tl, jl, 1e-4)
    _close(tcache.k, jcache.self_kv.k, 1e-4)
    assert tcache.pos.tolist() == [S + 6] * 2


def test_cross_cache_is_the_attended_kv():
    """The prefill's cross cache is ``make_cross_cache`` over the encoder
    output, bit for bit (the K/V the cross attention attended over), and
    stays in the compute dtype under a narrower self cache."""
    _, tc, _, tp = _model()
    b = _t(_batch(tc, 2, 7, 3))
    _, caches = TM.prefill(tp, tc, b, cache_len=10)
    enc = TW.encode(tp, tc, b["frames"])
    for i in range(tc.n_layers):
        lp = {k: v[i] for k, v in tp["dec_layers"]["cross"].items()}
        want = TA.make_cross_cache(lp, enc, tc)
        assert torch.equal(caches.ck[i], want.k)
        assert torch.equal(caches.cv[i], want.v)
    for kv in ("bfloat16", "int8"):
        c = TM.prefill(tp, dataclasses.replace(tc, kv_dtype=kv), b,
                       cache_len=10)[1]
        assert c.k.dtype == getattr(torch, kv)
        assert c.ck.dtype == torch.float32
        assert torch.equal(c.ck, caches.ck)
        assert (c.k_scale is not None) == (kv == "int8")


def test_decode_writes_self_cache_in_place():
    """A decode step writes each layer's self K/V row into the caller's
    tensors in place (the same ``data_ptr``, the row at ``pos`` moved),
    leaves the cross K/V as they were and returns ``pos + 1`` as a new
    tensor."""
    _, tc, _, tp = _model()
    _, caches = TM.prefill(tp, tc, _t(_batch(tc, 2, 6, 4)), cache_len=12)
    k0, ck0 = caches.k.clone(), caches.ck.clone()
    ptrs = [getattr(caches, f).data_ptr() for f in ("k", "v", "ck", "cv")]
    pos0 = caches.pos
    _, out = TM.decode_step(tp, tc, caches, torch.tensor([3, 5]))
    assert [getattr(out, f).data_ptr() for f in ("k", "v", "ck", "cv")] \
        == ptrs
    assert not torch.equal(out.k[:, :, 6], k0[:, :, 6])
    assert torch.equal(out.k[:, :, :6], k0[:, :, :6])
    assert torch.equal(out.ck, ck0)
    assert pos0.tolist() == [6, 6] and out.pos.tolist() == [7, 7]


def test_loss_and_grads_match_repro():
    """``model.loss`` (chunked CE of the decoder's hidden on the tied
    embedding, last position masked, no aux) and its gradients, the
    encoder's included, against ``jax.value_and_grad(repro.models.model.
    loss)``, 1e-4, on 24 tokens (chunk 32: one padded chunk)."""
    jc, tc, jp, tp = _model()
    b = _batch(tc, 2, 24, 5)
    jl, jg = jax.value_and_grad(lambda p: JM.loss(p, jc, _j(b)))(jp)
    tp = jax.tree.map(lambda v: v.detach().clone().requires_grad_(True), tp)
    tl = TM.loss(tp, tc, _t(b))
    tl.backward()
    _close(tl.detach(), jl, 1e-4)
    jleaves = dict(_leaves(jg))
    for path, v in _leaves(tp):
        assert v.grad is not None, path
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jleaves[path]),
                                   rtol=1e-4, atol=1e-4, err_msg=path)


def test_loss_with_remat_equals_without():
    """``cfg.remat`` recomputes each layer of both stacks in the backward:
    the same loss and gradients, bit for bit."""
    _, tc, _, tp = _model()
    b = _t(_batch(tc, 2, 16, 6))
    grads = []
    for remat in (False, True):
        p = jax.tree.map(lambda v: v.detach().clone().requires_grad_(True),
                         tp)
        TM.loss(p, dataclasses.replace(tc, remat=remat), b).backward()
        grads.append([v.grad for _, v in _leaves(p)])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_prefill_decode_consistency():
    """``tests/test_models.py:95`` on the port: a decode step after a
    prefill of S - 1 tokens gives the full forward's last logits (1e-4,
    f32)."""
    _, tc, _, tp = _model()
    b = _t(_batch(tc, 2, 24, 7))
    full, _ = TM.prefill(tp, tc, b)
    short = dict(b, tokens=b["tokens"][:, :-1])
    _, caches = TM.prefill(tp, tc, short, cache_len=28)
    dec, _ = TM.decode_step(tp, tc, caches, b["tokens"][:, -1])
    _close(dec, full[:, -1], 1e-4)


def test_flash_backend_token_identity():
    """``tests/test_attention_backend.py:93-125`` on the port: the flash
    and torch backends give the same 6 greedy tokens after a prefill
    (non-causal encoder and cross attention, B3 over the cross cache),
    and ``repro``'s."""
    jc, tc, jp, tp = _model()
    b = _batch(tc, 2, 12, 8)
    toks = {}
    for backend in ("torch", "flash"):
        c = dataclasses.replace(tc, attn_backend=backend)
        _, caches = TM.prefill(tp, c, _t(b), cache_len=24)
        tok, out = torch.zeros(2, dtype=torch.long), []
        for _ in range(6):
            logits, caches = TM.decode_step(tp, c, caches, tok)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        toks[backend] = torch.stack(out, 1)
    assert torch.equal(toks["torch"], toks["flash"])
    _, jcache = _j_prefill(jp, jc, _j(b), cache_len=24)
    tok, out = jnp.zeros((2,), jnp.int32), []
    for _ in range(6):
        logits, jcache = _j_decode(jp, jc, jcache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    np.testing.assert_array_equal(toks["flash"].numpy(),
                                  np.asarray(jnp.stack(out, 1)))


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_greedy_tokens_match_repro(kv):
    """``ServeEngine.generate`` on both sides: a 14-token prompt, 12 frames
    and 8 new tokens, greedy, exact; also with an int8 self cache (the
    cross cache stays f32 in both)."""
    jc, tc, jp, tp = _model()
    b = _batch(tc, 2, 14, 9)
    want = np.asarray(JEngine(jc, jp, max_len=22, kv_dtype=kv).generate(
        _j(b), 8))
    got = ServeEngine(tc, tp, max_len=22, kv_dtype=kv,
                      device="cpu").generate(b, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_frames_take_no_cache_position():
    """The prompt length is the token count: a 14-token prompt and 8 new
    tokens fit max_len 21 whatever the frames, and 9 new do not."""
    _, tc, _, tp = _model()
    eng = ServeEngine(tc, tp, max_len=21, device="cpu")
    b = _batch(tc, 1, 14, 10)
    assert eng.generate(b, 8).shape == (1, 8)
    with pytest.raises(ValueError, match="max_len 21"):
        eng.generate(b, 9)


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
@pytest.mark.parametrize("attack", ["signflip", "gaussian"])
def test_robust_greedy_under_attack_equals_clean(attack, share):
    """Robust m = 8 VRMOM K 8 at alpha 0.25, fused and unfused tails: the
    tokens under attack are the clean tokens, in both layouts (the
    replicated one decodes 8 replica rows of every self and cross cache)."""
    _, tc, _, tp = _model()
    b = _batch(tc, 2, 10, 11)
    clean = ServeEngine(tc, tp, max_len=18, device="cpu").generate(b, 8)
    for fuse in (True, False):
        rcfg = RobustDecodeConfig(m=8, estimator="vrmom", K=8, alpha=0.25,
                                  attack=attack, fuse_tail=fuse,
                                  share_replica_compute=share)
        got = ServeEngine(tc, tp, max_len=18, robust=rcfg,
                          device="cpu").generate(b, 8)
        torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize("robust", ["none", "shared", "replicated"])
def test_generate_equals_python_loop(robust):
    """``generate`` (the prefill written into the engine's buffers, cross
    K/V included, the replicas copied) equals the eager loop, twice on one
    engine with other frames (the second reuses the buffers)."""
    _, tc, _, tp = _model()
    rcfg = None if robust == "none" else RobustDecodeConfig(
        m=8, attack="gaussian", share_replica_compute=robust == "shared")
    eng = ServeEngine(tc, tp, max_len=24, robust=rcfg, device="cpu")
    for seed in (12, 13):
        b = _batch(tc, 3, 11, seed)
        torch.testing.assert_close(eng.generate(b, 9),
                                   eng.generate_python_loop(b, 9),
                                   rtol=0, atol=0)


def _serve_requests(cfg):
    """``tests/test_serve.py:170-194``'s requests: 3 prompts of 5, 8 and 11
    tokens, each with its own frames [12, 128] (numpy seed 3, drawn in its
    order), 4 new tokens each."""
    rs = np.random.RandomState(3)
    reqs = []
    for i in range(3):
        frames = rs.randn(cfg.encoder.n_frames, cfg.d_model).astype(
            np.float32)
        reqs.append((rs.randint(0, cfg.vocab, size=(5 + 3 * i,)), frames))
    return reqs


_REPRO_POOL = {}


def _repro_pool_tokens():
    """``repro``'s ``Scheduler`` over 2 slots of 40 (blocks of 2) on
    ``_serve_requests``, greedy, computed once."""
    if not _REPRO_POOL:
        jc, tc, jp, _ = _model()
        jsched = JScheduler(JEngine(jc, jp, max_len=40, n_slots=2),
                            decode_block=2)
        uids = [jsched.submit(JRequest(tokens=t, max_new_tokens=4,
                                       extras={"frames": f}))
                for t, f in _serve_requests(tc)]
        done = jsched.run()
        _REPRO_POOL["toks"] = [list(map(int, done[u].tokens)) for u in uids]
    return _REPRO_POOL["toks"]


@pytest.mark.parametrize("attack", ["none", "signflip", "gaussian"])
@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
def test_pool_equals_solo_and_repro(share, attack):
    """``test_pool_decode_other_families`` (whisper) on both packages: 3
    requests, each with its own frames, through 2 slots (max_len 40,
    blocks of 2) on 8 robust replicas: each completion equals ``repro``'s
    ``Scheduler``'s clean one and its solo ``generate``, exactly."""
    _, tc, _, tp = _model()
    want = _repro_pool_tokens()
    reqs = _serve_requests(tc)
    eng = ServeEngine(tc, tp, max_len=40, n_slots=2, device="cpu",
                      robust=RobustDecodeConfig(
                          m=8, attack=attack, share_replica_compute=share))
    sched = Scheduler(eng, decode_block=2)
    uids = [sched.submit(Request(tokens=t, max_new_tokens=4,
                                 extras={"frames": f})) for t, f in reqs]
    done = sched.run()
    got = [list(map(int, done[u].tokens)) for u in uids]
    assert got == want
    for (t, f), toks in zip(reqs, got):
        assert toks == eng.generate({"tokens": t[None], "frames": f[None]},
                                    4)[0].tolist()


def test_pool_plain_equals_repro():
    """The pool with no robust tail equals ``repro``'s ``Scheduler``."""
    _, tc, _, tp = _model()
    sched = Scheduler(ServeEngine(tc, tp, max_len=40, n_slots=2,
                                  device="cpu"), decode_block=2)
    uids = [sched.submit(Request(tokens=t, max_new_tokens=4,
                                 extras={"frames": f}))
            for t, f in _serve_requests(tc)]
    done = sched.run()
    assert [done[u].tokens for u in uids] == _repro_pool_tokens()


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
def test_admission_into_an_evicted_slot(share):
    """A request admitted into a slot another request held, with other
    frames, gives its solo ``generate``'s tokens: the admission overwrote
    the slot's self and cross K/V in every replica row."""
    _, tc, _, tp = _model()
    a, b, c = (_batch(tc, 1, n, s) for n, s in ((12, 15), (7, 16), (9, 17)))
    eng = ServeEngine(tc, tp, max_len=40, n_slots=2, device="cpu",
                      robust=RobustDecodeConfig(m=8, attack="signflip",
                                                share_replica_compute=share))
    pool = eng.make_pool()
    pool, ta = eng.admit(pool, 0, a)
    pool, tb = eng.admit(pool, 1, b)
    pool, toks = eng.decode_pool(pool, torch.tensor([ta, tb]), 3)
    pool = eng.evict(pool, 1)
    rows = [r * pool.n_slots + 1 for r in range(pool.m)]  # slot 1's rows
    before = pool.caches.ck[:, rows].clone()
    pool, tc0 = eng.admit(pool, 1, c)
    assert not torch.equal(pool.caches.ck[:, rows], before)
    cur, out = torch.tensor([int(toks[-1, 0]), tc0]), [tc0]
    for _ in range(5):
        pool, toks = eng.decode_pool(pool, cur, 1)
        cur = toks[-1].clone()
        out.append(int(toks[-1, 1]))
    assert out == eng.generate(c, 6)[0].tolist()


@pytest.mark.parametrize("share", [True, False],
                         ids=["shared", "replicated"])
def test_kv_bytes_per_slot_counts_the_cross_cache(share):
    """``serve.kv_bytes_per_slot``: a slot's f32 self K/V (max_len
    positions) and cross K/V (F frames) over every layer, its int32
    position, times the m replica rows of the replicated layout; built on
    the meta device."""
    _, tc, _, tp = _model()
    m = 1 if share else 8
    reg = MetricsRegistry()
    ServeEngine(tc, tp, max_len=32, obs=reg, device="cpu",
                robust=RobustDecodeConfig(m=8, share_replica_compute=share))
    per = tc.n_layers * 2 * tc.n_kv_heads * tc.head_dim * 4
    want = m * (per * (32 + tc.encoder.n_frames) + 4)
    assert reg.gauges["serve.kv_bytes_per_slot"] == want
    meta = TC.pool_caches(tc, 3, 32, m=m, device="meta")
    assert meta.ck.device.type == "meta"
    assert tuple(meta.ck.shape) == (2, 3 * m, 12, 2, 32)
