"""repro_torch models: the reduced qwen3 against ``repro.models.model``.

``repro``'s seeded params go through ``convert.params_from_jax`` so both
sides compute the same function; prefill logits, teacher-forced decode
logits and the KV caches are compared across attention backends and KV
dtypes. Tolerance 1e-4 on f32 logits and caches: matmuls and softmax sums
run in another order in XLA and in PyTorch (observed differences are
~1e-6). Quantized caches are held to the rounding they add: one bf16 ulp
(2^-8 relative) for a bf16 cache, one int8 step for an int8 cache (a
value within 1e-6 of a rounding boundary may land on either side), and
2e-3 on the logits that read them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import expected_shapes, params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

torch.set_num_threads(1)

# (port attention backend, JAX attention backend)
BACKENDS = [("torch", "jnp"), ("flash", "flash")]
KV_DTYPES = [None, "bfloat16", "int8"]
# jitted reference steps (the config is static): one compile per config
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _cfgs(models, backend, kv_dtype=None):
    jcfg, tcfg, jp, tp = models
    tb, jb = backend
    return (dataclasses.replace(jcfg, attn_backend=jb, kv_dtype=kv_dtype),
            dataclasses.replace(tcfg, attn_backend=tb, kv_dtype=kv_dtype),
            jp, tp)


def _tokens(B=2, S=12, seed=1):
    return np.random.RandomState(seed).randint(0, 512, size=(B, S))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _field(cfg, name):
    """A config field, with a nested config (``vision``) as a dict."""
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("name", ["qwen3-1.7b", "minitron-4b",
                                  "starcoder2-7b", "llama3-405b",
                                  "phi-3-vision-4.2b", "granite-moe-3b-a800m",
                                  "mixtral-8x7b"])
def test_config_mirrors_repro(name):
    jc, tc = j_get_arch(name), t_get_arch(name)
    for f in dataclasses.fields(tc):
        assert _field(tc, f.name) == _field(jc, f.name), f.name
    jr, tr = jc.reduced(), tc.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "param_dtype", "compute_dtype", "attn_chunk",
              "vision", "moe", "sliding_window"):
        assert _field(tr, f) == _field(jr, f), f


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_logits_match(models, backend, last_only):
    jcfg, tcfg, jp, tp = _cfgs(models, backend)
    toks = _tokens()
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        cache_len=24, last_only=last_only)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        cache_len=24, last_only=last_only)
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.pos.dtype == torch.int32 and tc.pos.tolist() == [12] * 2


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_teacher_forced_decode_matches(models, backend, kv_dtype):
    """8 decode steps fed the same tokens on both sides: logits per step and
    the caches after the last one."""
    jcfg, tcfg, jp, tp = _cfgs(models, backend, kv_dtype)
    toks = _tokens(S=10, seed=2)
    feed = _tokens(S=8, seed=3)
    _, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       cache_len=20)
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                       cache_len=20)
    tol = 1e-4 if kv_dtype is None else 2e-3
    for s in range(feed.shape[1]):
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(feed[:, s], jnp.int32))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, s]))
        _close(tl, jl, tol)
    assert tc.pos.tolist() == [18] * 2
    assert int(np.asarray(jc.pos).ravel()[0]) == 18
    if kv_dtype == "int8":
        assert tc.k.dtype == torch.int8
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            diff = np.abs(a.numpy().astype(np.int32)
                          - np.asarray(b).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        _close(tc.k_scale, jc.k_scale, 1e-5)
        _close(tc.v_scale, jc.v_scale, 1e-5)
    elif kv_dtype == "bfloat16":
        assert tc.k.dtype == torch.bfloat16
        _close(tc.k.float(), np.asarray(jc.k).astype(np.float32), 2 ** -8)
        _close(tc.v.float(), np.asarray(jc.v).astype(np.float32), 2 ** -8)
    else:
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_from_empty_cache_matches(models, kv_dtype):
    """``init_cache`` then decode only (no prefill): stacked [L, B, T, ...]
    zero caches (with zero scales for int8) as in ``repro``."""
    jcfg, tcfg, jp, tp = _cfgs(models, BACKENDS[1], kv_dtype)
    jc = JM.init_cache(jcfg, 2, 6)
    tc = TM.init_cache(tcfg, 2, 6, device="cpu")
    assert tuple(tc.k.shape) == jc.k.shape == (2, 2, 6, 2, 32)
    assert (tc.k_scale is None) == (jc.k_scale is None)
    feed = _tokens(S=4, seed=6)
    for s in range(feed.shape[1]):
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(feed[:, s], jnp.int32))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, s]))
        _close(tl, jl, 1e-4 if kv_dtype is None else 2e-3)


def test_sliding_window_ring_cache_matches(models):
    """A window shorter than the prompt: prefill masks it in ``mha`` and
    keeps a ring cache of ``window`` slots; decode writes at pos % window."""
    jcfg, tcfg, jp, tp = models
    toks, feed = _tokens(S=11, seed=4), _tokens(S=5, seed=5)
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, window=8)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        window=8)
    _close(tl, jl)
    assert tuple(tc.k.shape) == jc.k.shape and tc.k.shape[2] == 8
    for s in range(feed.shape[1]):
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(feed[:, s], jnp.int32),
                           window=8)
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, s]),
                                window=8)
        _close(tl, jl)
    _close(tc.k, jc.k)


def test_layers_match_repro():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 4, 32).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(32)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    h = rs.randn(2, 3, 16).astype(np.float32)
    w = [rs.randn(*s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    _close(TL.swiglu(torch.from_numpy(h), *(torch.from_numpy(a) for a in w)),
           JL.swiglu(jnp.asarray(h), *(jnp.asarray(a) for a in w)), 1e-5)


def _shapes(tree, prefix=""):
    """{path: shape} of a nested dict whose leaves are arrays or shapes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(getattr(v, "shape", v))
    return out


def test_seeded_init_shapes_and_scales():
    """The port's own init: repro's shapes, dtypes and distributions."""
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tp = TM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda k: JM.init(k, jcfg),
                             jax.random.PRNGKey(0))
    assert _shapes(tp) == _shapes(jshapes) == _shapes(expected_shapes(tcfg))
    attn = tp["layers"]["attn"]
    assert abs(float(attn["wq"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002
    assert torch.all(tp["norm_f"] == 1)


def test_params_from_jax_bf16_leaves():
    jcfg = dataclasses.replace(j_get_arch("qwen3-1.7b").reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(t_get_arch("qwen3-1.7b").reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(1), jcfg))
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    tp = params_from_jax(tree, tcfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"].float().numpy(),
                                  tree["layers"]["attn"]["wq"]
                                  .astype(np.float32))


def test_params_from_jax_rejects_mismatch(models):
    jcfg, tcfg, jp, _ = models
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "norm_f"},
                        tcfg, device="cpu")


def test_unported_family_refused():
    """Every family of repro is ported; a family string outside them
    raises, naming the known ones."""
    with pytest.raises(ValueError, match="unknown family.*encdec"):
        dataclasses.replace(t_get_arch("qwen3-1.7b"), family="audio")
