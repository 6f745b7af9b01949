"""repro_torch's mamba2 block and the ssm family against ``repro``.

The SSD pieces (``ssd_chunked``, ``ssd_decode_step``, the depthwise conv
and its one-step form) take the same numpy inputs on both sides; the
block takes ``repro``'s ``mamba2_init`` leaves as torch tensors; the
models take ``repro``'s seeded params through ``convert.params_from_jax``
(mamba2-2.7b and zamba2-7b at their ``reduced()`` sizes, in f32).
Tolerances: 1e-5 on the SSD pieces and the block in f32 (the same
arithmetic; cumulative sums and contractions in another order); 1e-4 on
f32 logits, caches, the loss and its gradients (``test_torch_models.py``'s
tolerance); ``repro``'s own 2e-4 (chunked against the naive recurrence),
2e-3 (prefill then decode against one prefill) and 3e-3 (four decode
steps against teacher-forced prefills) where its tests use them; a bf16
y within 4e-3 of the largest |y| (one bf16 ulp, 2^-8: the port rounds
each intermediate at the points ``repro`` does), its f32 h_T within 1e-5
of the largest |h|. The hybrid's own cases and the serving path of both
families are ``test_torch_hybrid.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import expected_shapes, params_from_jax
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM

torch.set_num_threads(1)

NAMES = ["mamba2-2.7b", "zamba2-7b"]
_MODELS = {}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(name, **kw):
    jc, tc = j_get_arch(name).reduced(), t_get_arch(name).reduced()
    if "ssm" in kw:
        j_ssm = dataclasses.replace(jc.ssm, **kw["ssm"])
        t_ssm = dataclasses.replace(tc.ssm, **kw.pop("ssm"))
        return (dataclasses.replace(jc, ssm=j_ssm, **kw),
                dataclasses.replace(tc, ssm=t_ssm, **kw))
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _model(name, **kw):
    """(repro's config, the port's, repro's params, the port's), cached."""
    key = (name, repr(sorted(kw.items())))
    if key not in _MODELS:
        jc, tc = _cfgs(name, **dict(kw))
        jp = JM.init(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _ssd_inputs(seed, b, S, H, P, G, N, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, S, H))).astype(np.float32)
    A = -np.exp(rs.randn(H) * 0.3).astype(np.float32)
    B = (rs.randn(b, S, G, N) * 0.5).astype(np.float32)
    C = (rs.randn(b, S, G, N) * 0.5).astype(np.float32)
    h0 = (rs.randn(b, H, P, N) * 0.5).astype(np.float32)
    return x.astype(dtype), dt, A, B.astype(dtype), C.astype(dtype), h0


# shapes (b, S, H, P, G, N): N > P and N < P take the two contraction
# orders; G = 2 repeats the groups over the heads; S = 37 pads the last
# chunk, S = 32 fills it
SSD_SHAPES = [(2, 37, 4, 8, 1, 16), (2, 37, 4, 8, 2, 16),
              (2, 37, 4, 32, 1, 16), (1, 32, 2, 16, 1, 16)]


# -- the SSD pieces ----------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=["N>P", "G2", "N<P", "N=P-full"])
def test_ssd_chunked_matches_repro(shape, with_h0):
    """y and h_T within 1e-5 of ``repro``'s, chunk 8 over S = 37 (padded)
    or 32, from zeros or a given state."""
    x, dt, A, B, C, h0 = _ssd_inputs(0, *shape)
    h0 = h0 if with_h0 else None
    jy, jh = JM2.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=8,
                             h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TM2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                             chunk=8,
                             h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == jy.shape and th.shape == jh.shape
    assert th.dtype == torch.float32
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)


@pytest.mark.parametrize("shape", SSD_SHAPES[:3], ids=["N>P", "G2", "N<P"])
def test_ssd_chunked_matches_naive_recurrence(shape):
    """``repro``'s defining check (tests/test_models.py:12-35) on the port:
    the chunked scan equals the per-step recurrence (2e-4), and chunks of
    6, 7 (not dividing S) and S give the same y and h_T (1e-4)."""
    x, dt, A, B, C, h0 = map(torch.from_numpy, _ssd_inputs(1, *shape))
    y, hT = TM2.ssd_chunked(x, dt, A, B, C, chunk=8, h0=h0)
    h, ys = h0, []
    for t in range(x.shape[1]):
        y_t, h = TM2.ssd_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                     h)
        ys.append(y_t)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(hT, h, rtol=2e-4, atol=2e-4)
    for chunk in (6, 7, x.shape[1]):
        y2, h2 = TM2.ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)
        torch.testing.assert_close(y2, y, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h2, hT, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 1, 64),
                                   (2, 64, 4, 64, 1, 16)],
                         ids=["N>P", "N<P"])
def test_ssd_chunked_bf16_matches_repro(shape):
    """bf16 x, B and C (dt and A f32) at chunk 16: the port casts where
    ``repro`` casts and contracts in its order, so y stays within one bf16
    ulp (4e-3) of the largest |y| of ``repro``'s bf16 y, and h_T (f32)
    within 1e-5 of its largest |h|."""
    x, dt, A, B, C, h0 = _ssd_inputs(2, *shape, dtype=ml_dtypes.bfloat16)
    jy, jh = JM2.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=16,
                             h0=jnp.asarray(h0))
    ty, th = TM2.ssd_chunked(*map(_torch, (x, dt, A, B, C)), chunk=16,
                             h0=torch.from_numpy(h0))
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    jy, jh = np.asarray(jy, np.float32), np.asarray(jh)
    ys, hs = np.abs(jy).max(), np.abs(jh).max()
    _close(ty.float().numpy() / ys, jy / ys, 4e-3)
    _close(th.numpy() / hs, jh / hs, 1e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_repro(G):
    """One step of the recurrence within 1e-5 of ``repro``'s; written in
    place into the state (``out=h``) it gives the same bits."""
    x, dt, A, B, C, h0 = _ssd_inputs(3, 2, 1, 4, 8, G, 16)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], h0)
    jy, jh = JM2.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = TM2.ssd_decode_step(*map(torch.from_numpy, args))
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)
    h = torch.from_numpy(h0.copy())
    ptr = h.data_ptr()
    y2, h2 = TM2.ssd_decode_step(*map(torch.from_numpy, args[:-1]), h,
                                 out=h)
    assert h2.data_ptr() == ptr
    assert torch.equal(y2, ty) and torch.equal(h, th)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state"])
def test_conv_matches_repro(with_state):
    """The causal depthwise conv over a sequence (K = 4) and its new state,
    from zeros or a given state, within 1e-5; also at S = 2 < K - 1, whose
    state keeps part of the old one."""
    rs = np.random.RandomState(4)
    w = rs.randn(4, 24).astype(np.float32)
    for S in (11, 2):
        x = rs.randn(2, S, 24).astype(np.float32)
        st = rs.randn(2, 3, 24).astype(np.float32) if with_state else None
        jy, js = JM2._conv(jnp.asarray(x), jnp.asarray(w),
                           None if st is None else jnp.asarray(st))
        ty, ts = TM2._conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if st is None else torch.from_numpy(st))
        _close(ty, jy, 1e-5)
        _close(ts, js, 1e-5)


def test_conv_step_matches_repro():
    """Five one-step conv updates from a state equal ``repro``'s (1e-5), and
    the steps together equal the sequence conv from that state."""
    rs = np.random.RandomState(5)
    w = rs.randn(4, 24).astype(np.float32)
    xs = rs.randn(2, 5, 24).astype(np.float32)
    st0 = rs.randn(2, 3, 24).astype(np.float32)
    js, ts, ys = jnp.asarray(st0), torch.from_numpy(st0), []
    for t in range(5):
        jy, js = JM2._conv_step(js, jnp.asarray(xs[:, t:t + 1]),
                                jnp.asarray(w))
        ty, ts = TM2._conv_step(ts, torch.from_numpy(xs[:, t:t + 1]),
                                torch.from_numpy(w))
        _close(ty, jy, 1e-5)
        _close(ts, js, 1e-5)
        ys.append(ty)
    seq, state = TM2._conv(torch.from_numpy(xs), torch.from_numpy(w),
                           torch.from_numpy(st0))
    torch.testing.assert_close(torch.stack(ys, 1), seq, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(ts, state, rtol=0, atol=0)


# -- the block ---------------------------------------------------------------

def _block(name="mamba2-2.7b", seed=3):
    jc, tc = _cfgs(name)
    jp = JM2.mamba2_init(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, {k: _torch(v) for k, v in jp.items()}


def test_block_init_shapes_and_dtypes():
    """The port's ``mamba2_init`` has ``repro``'s leaves, shapes and dtypes
    (``A_log``, ``D``, ``dt_bias`` f32 in a bf16 model), stacked under a
    leading (L,)."""
    jc, tc = _cfgs("mamba2-2.7b", param_dtype="bfloat16")
    want = jax.eval_shape(lambda k: JM2.mamba2_init(k, jc),
                          jax.random.PRNGKey(0))
    got = TM2.mamba2_init(torch.Generator().manual_seed(0), tc, lead=(3,))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == (3,) + v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k


def test_block_forward_and_decode_match_repro():
    """The reduced mamba2 block: a forward of 21 tokens with its cache (h,
    both conv tails, pos), then 3 decode steps written into that cache in
    place, each output and the state within 1e-5 of ``repro``'s."""
    jc, tc, jp, tp = _block()
    x = np.random.RandomState(6).randn(2, 21, jc.d_model).astype(np.float32)
    jo, jcache = JM2.mamba2_forward(jp, jnp.asarray(x), jc,
                                    return_cache=True)
    to, tcache = TM2.mamba2_forward(tp, torch.from_numpy(x), tc,
                                    make_cache=True)
    _close(to, jo, 1e-5)
    for f in ("h", "conv", "conv_bc"):
        _close(getattr(tcache, f), getattr(jcache, f), 1e-5)
    assert tcache.pos.tolist() == [21, 21]
    tcache = TM2.SSMCache(*(t.contiguous() for t in tcache))
    for s in range(3):
        x1 = np.random.RandomState(10 + s).randn(2, 1, jc.d_model).astype(
            np.float32)
        jo, jcache = JM2.mamba2_decode(jp, jnp.asarray(x1), jc, jcache)
        to, tcache = TM2.mamba2_decode(tp, torch.from_numpy(x1), tc, tcache)
        _close(to, jo, 1e-5)
    for f in ("h", "conv", "conv_bc"):
        _close(getattr(tcache, f), getattr(jcache, f), 1e-5)
    assert tcache.pos.tolist() == [24, 24]


def test_block_forward_continues_from_a_cache():
    """A forward given a cache continues from its state and conv tails, as
    ``repro``'s does (1e-5), and 9 + 12 tokens give the 21-token forward's
    output and state (1e-4)."""
    jc, tc, jp, tp = _block()
    x = torch.from_numpy(
        np.random.RandomState(7).randn(2, 21, jc.d_model).astype(np.float32))
    full, fcache = TM2.mamba2_forward(tp, x, tc, make_cache=True)
    _, c9 = TM2.mamba2_forward(tp, x[:, :9], tc, make_cache=True)
    jo, jc9 = JM2.mamba2_forward(jp, jnp.asarray(x[:, :9].numpy()), jc,
                                 return_cache=True)
    rest, rcache = TM2.mamba2_forward(tp, x[:, 9:], tc, cache=c9,
                                      make_cache=True)
    jrest, jrcache = JM2.mamba2_forward(jp, jnp.asarray(x[:, 9:].numpy()),
                                        jc, cache=jc9, return_cache=True)
    _close(rest, jrest, 1e-5)
    _close(rcache.h, jrcache.h, 1e-5)
    torch.testing.assert_close(rest, full[:, 9:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rcache.h, fcache.h, rtol=1e-4, atol=1e-4)
    assert rcache.pos.tolist() == [21, 21]


def test_block_forward_writes_into_out():
    """``out=``: the new state lands in the given tensors (their addresses
    kept) with the bits of the returned-cache forward."""
    jc, tc, jp, tp = _block()
    x = torch.from_numpy(
        np.random.RandomState(8).randn(2, 13, jc.d_model).astype(np.float32))
    _, want = TM2.mamba2_forward(tp, x, tc, make_cache=True)
    out = TM2.init_cache(tc, 2, 1)
    out = TM2.SSMCache(*(t[0] for t in out[:3]), pos=out.pos)
    ptrs = [t.data_ptr() for t in out]
    _, got = TM2.mamba2_forward(tp, x, tc, make_cache=True, out=out)
    assert [t.data_ptr() for t in got] == ptrs
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the ssm model -----------------------------------------------------------

@pytest.mark.parametrize("variant", [{}, {"ssm": {"n_groups": 2}}],
                         ids=["reduced", "groups2"])
def test_ssm_prefill_and_teacher_forced_decode_match(variant):
    """Reduced mamba2-2.7b (and with 2 B/C groups): prefill logits and the
    stacked ``SSMCache`` of a 21-token prompt (chunk 16: one padded chunk),
    then 6 decode steps fed the same tokens, within 1e-4 of ``repro``."""
    jc, tc, jp, tp = _model("mamba2-2.7b", **variant)
    toks = np.random.RandomState(1).randint(0, tc.vocab, size=(2, 21))
    feed = np.random.RandomState(2).randint(0, tc.vocab, size=(2, 6))
    jl, jcache = JM.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                            cache_len=30)
    tl, tcache = TM.prefill(tp, tc, {"tokens": torch.from_numpy(toks)},
                            cache_len=30)
    assert isinstance(tcache, TM2.SSMCache)
    _close(tl, jl, 1e-4)
    for f in ("h", "conv", "conv_bc"):
        assert tuple(getattr(tcache, f).shape) == getattr(jcache, f).shape
        _close(getattr(tcache, f), getattr(jcache, f), 1e-4)
    for s in range(feed.shape[1]):
        jl, jcache = JM.decode_step(jp, jc, jcache,
                                    jnp.asarray(feed[:, s], jnp.int32))
        tl, tcache = TM.decode_step(tp, tc, tcache,
                                    torch.from_numpy(feed[:, s]))
        _close(tl, jl, 1e-4)
    _close(tcache.h, jcache.h, 1e-4)
    assert tcache.pos.tolist() == [27, 27]


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_consistency(name):
    """``repro``'s check (tests/test_models.py:95-128) on the port's own
    init: decoding the last token after a prefill of the others gives the
    full prefill's last logits (2e-3)."""
    _, tc = _cfgs(name)
    params = TM.init(tc, torch.Generator().manual_seed(7), device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(8))
    full, _ = TM.prefill(params, tc, {"tokens": toks})
    _, caches = TM.prefill(params, tc, {"tokens": toks[:, :-1]},
                           cache_len=28)
    dec, _ = TM.decode_step(params, tc, caches, toks[:, -1])
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_multi_token_decode_matches_full_forward(name):
    """``repro``'s check (tests/test_models.py:160-182): 4 decode steps after
    a 12-token prefill equal the teacher-forced prefill's logits (3e-3)."""
    _, tc = _cfgs(name)
    params = TM.init(tc, torch.Generator().manual_seed(11), device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(12))
    _, caches = TM.prefill(params, tc, {"tokens": toks[:, :12]},
                           cache_len=18)
    full, _ = TM.prefill(params, tc, {"tokens": toks})
    for t in range(4):
        logits, caches = TM.decode_step(params, tc, caches, toks[:, 12 + t])
        torch.testing.assert_close(logits, full[:, 12 + t], rtol=3e-3,
                                   atol=3e-3)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order (JAX's leaf order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_repro(name):
    """``model.loss`` and its gradients against
    ``jax.value_and_grad(repro.models.model.loss)``, 1e-4, on 24 tokens
    (chunk 16: one padded chunk). The reduced hybrid's tail layer runs in
    neither package: ``repro``'s gradient there is zero, the port's None."""
    jc, tc, jp, tp = _model(name)
    toks = np.random.RandomState(3).randint(0, tc.vocab, size=(2, 24))
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss(p, jc, {"tokens": jnp.asarray(toks)}))(jp)
    tp = _clone(tp)
    for _, v in _leaves(tp):
        v.requires_grad_(True)
    tl = TM.loss(tp, tc, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    _close(tl.detach(), jl, 1e-4)
    jleaves = dict(_leaves(jg))
    for path, v in _leaves(tp):
        want = np.asarray(jleaves[path])
        if v.grad is None:
            assert path.startswith("mamba_t/") and not want.any(), path
            continue
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_decode_writes_the_state_in_place(name):
    """A decode step writes every state tensor of the caller's caches in
    place: the tensors' ``data_ptr``s are those of before the step and
    their values moved; ``pos`` advances as a new tensor."""
    _, tc, _, tp = _model(name)
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(0, tc.vocab, size=(2, 9)))
    _, caches = TM.prefill(tp, tc, {"tokens": toks}, cache_len=12)
    before = {f: getattr(caches, f).clone() for f in ("h", "conv",
                                                      "conv_bc")}
    ptrs = {f: getattr(caches, f).data_ptr() for f in caches._fields
            if getattr(caches, f) is not None}
    _, new = TM.decode_step(tp, tc, caches, toks[:, -1])
    for f, p in ptrs.items():
        if f != "pos":
            assert getattr(new, f).data_ptr() == p, f
    for f, old in before.items():
        assert not torch.equal(getattr(caches, f), old), f
    assert new.pos.tolist() == [10, 10] and caches.pos.tolist() == [9, 9]


@pytest.mark.parametrize("name", NAMES)
def test_expected_shapes_at_full_width(name):
    """``convert.expected_shapes`` at full width is ``repro``'s traced init
    (nothing allocated): mamba2-2.7b's 64 stacked layers, zamba2-7b's 13
    groups of 6 and tail of 3; at the reduced size the hybrid's tail of 0
    keeps ``repro``'s one unused tail layer, and the port's own init has
    those shapes."""
    for jc, tc in ((j_get_arch(name), t_get_arch(name)), _cfgs(name)):
        want = jax.eval_shape(lambda k: JM.init(k, jc), jax.random.PRNGKey(0))
        shapes = dict(_leaves(expected_shapes(tc)))
        assert shapes == {p: v.shape for p, v in _leaves(want)}
    tp = TM.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(v.shape) for p, v in _leaves(tp)} == shapes
    assert {p: str(v.dtype).split(".")[-1] for p, v in _leaves(tp)} \
        == {p: str(v.dtype) for p, v in _leaves(want)}
    if name == "zamba2-7b":
        full = expected_shapes(t_get_arch(name))
        assert full["mamba_g"]["norm"] == (13, 6, 3584)
        assert full["mamba_t"]["norm"] == (3, 3584)
        assert shapes["mamba_t/norm"] == (1, 64 * 2)
        assert full["shared"]["attn"]["wq"] == (3584, 32, 112)
    else:
        assert expected_shapes(t_get_arch(name))["layers"]["ssm"][
            "A_log"] == (64, 80)
    assert TM.active_param_count(tp, tc) == TM.param_count(tp) \
        == sum(int(np.prod(v.shape)) for _, v in _leaves(want))


def test_families_registered():
    """Both configs come from the registry with ``repro``'s fields, as does
    whisper-medium, the last family ported (its encoder too)."""
    for name in NAMES:
        jc, tc = j_get_arch(name), t_get_arch(name)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "d_head", "rope", "hybrid_attn_every",
                  "tie_embeddings"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
        assert tc.attention_free == jc.attention_free
        assert tc.sub_quadratic == jc.sub_quadratic
        rj, rt = jc.reduced(), tc.reduced()
        for f in ("n_layers", "hybrid_attn_every", "d_model", "n_heads"):
            assert getattr(rt, f) == getattr(rj, f), f
        assert dataclasses.asdict(rt.ssm) == dataclasses.asdict(rj.ssm)
    jc, tc = j_get_arch("whisper-medium"), t_get_arch("whisper-medium")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "rope", "tie_embeddings"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert dataclasses.asdict(tc.encoder) == dataclasses.asdict(jc.encoder)
    assert tc.ssm is None and not tc.attention_free
