"""repro_torch configs past qwen3-1.7b against ``repro``.

The dense configs minitron-4b, starcoder2-7b and llama3-405b and the vlm
phi-3-vision-4.2b (a dense LM behind stub patch embeddings), each at its
``reduced()`` size and in variants of it whose head dim (96, 112) and
query group (9, 16) are those of the full-width configs, which B2 and B3
take since their 96/112 and 16-head instances came in. ``repro``'s seeded
params go through ``convert.params_from_jax``; both sides run their
attention kernels (``"flash"``: the Pallas kernels in interpret mode, the
port's plain versions). Tolerances: 1e-5 on f32 logits and caches (the
products sum in another order in XLA and in PyTorch; observed ~1e-6),
greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.models import model as JM
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get as t_get_arch
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.convert import expected_shapes, params_from_jax
from repro_torch.models import model as TM
from repro_torch.serve import RobustDecodeConfig, ServeEngine

torch.set_num_threads(1)

NEW = ["minitron-4b", "starcoder2-7b", "llama3-405b", "phi-3-vision-4.2b"]
# the moe family (tests/test_torch_moe.py holds it against repro)
MOE = ["granite-moe-3b-a800m", "mixtral-8x7b"]
# the ssm and hybrid families (tests/test_torch_ssm.py, test_torch_hybrid.py)
SSM = ["mamba2-2.7b", "zamba2-7b"]
# (config, (d_head, n_heads, n_kv_heads) replaced into reduced(), or None)
CASES = [(name, None) for name in NEW] + [
    ("phi-3-vision-4.2b", (96, 4, 4)),   # phi-3-vision's dh 96, G 1
    ("phi-3-vision-4.2b", (112, 8, 2)),  # zamba2's dh 112
    ("starcoder2-7b", (128, 9, 1)),      # starcoder2-7b's G 9
    ("starcoder2-7b", (96, 18, 2)),
    ("llama3-405b", (112, 16, 1)),       # llama3-405b's G 16
]
IDS = [name if v is None else f"{name}-dh{v[0]}-{v[1]}x{v[2]}"
       for name, v in CASES]
B, S, N_NEW = 2, 10, 6
_j_prefill = jax.jit(JM.prefill, static_argnums=1,
                     static_argnames=("window", "cache_len", "last_only"))
_j_decode = jax.jit(JM.decode_step, static_argnums=1,
                    static_argnames=("window",))
_MODELS = {}


def _case(name, variant):
    """(JAX config, port config, JAX params, port params), cached."""
    key = (name, variant)
    if key not in _MODELS:
        kw = {"attn_backend": "flash"}
        if variant is not None:
            kw.update(d_head=variant[0], n_heads=variant[1],
                      n_kv_heads=variant[2])
        jc = dataclasses.replace(j_get_arch(name).reduced(), **kw)
        tc = dataclasses.replace(t_get_arch(name).reduced(), **kw)
        jp = JM.init(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _batch(cfg, seed=1, S=S):
    """numpy prompts, with 4 stub patches for a vlm."""
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab, size=(B, S))}
    if cfg.family == "vlm":
        batch["patches"] = (0.5 * rs.randn(B, cfg.vision.n_patches,
                                           cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_registry_mirrors_repro():
    """The port lists every name repro lists, each of repro's family; an
    unknown name raises KeyError."""
    ported = t_list_archs()
    assert ported == sorted(["qwen3-1.7b"] + NEW + MOE + SSM
                            + ["whisper-medium"])
    assert ported == sorted(j_list_archs())
    for name in ported:
        assert t_get_arch(name).family == j_get_arch(name).family, name
    with pytest.raises(KeyError, match="unknown"):
        t_get_arch("no-such-model")


@pytest.mark.parametrize("name", NEW + ["qwen3-1.7b"] + MOE + SSM)
def test_expected_shapes_match_repro_at_full_width(name):
    """``convert`` takes every ported config: its shapes at full width are
    those of repro's init (traced, nothing allocated), the untied
    ``lm_head``, a moe layer's router and stacked experts, an ssm layer's
    mamba2 block and the hybrid's grouped, tail and shared trees
    included."""
    jc, tc = j_get_arch(name), t_get_arch(name)
    shapes = jax.eval_shape(lambda k: JM.init(k, jc), jax.random.PRNGKey(0))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = tuple(getattr(v, "shape", v))
        return out

    assert flat(expected_shapes(tc)) == flat(shapes)
    assert ("lm_head" in shapes) == (not tc.tie_embeddings)


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_prefill_logits_match(name, variant):
    jc, tc, jp, tp = _case(name, variant)
    batch = _batch(tc)
    jl, jcache = _j_prefill(jp, jc, _j(batch), cache_len=24)
    tl, tcache = TM.prefill(tp, tc, _t(batch), cache_len=24)
    n = S + (tc.vision.n_patches if tc.family == "vlm" else 0)
    assert tuple(tl.shape) == jl.shape == (B, n, tc.vocab)
    _close(tl, jl)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)
    assert tcache.pos.tolist() == [n] * B
    assert n == int(np.asarray(jcache.pos).ravel()[0])


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_teacher_forced_decode_matches(name, variant):
    """4 decode steps after the prefill, fed the same tokens on both
    sides: the decode positions continue past a vlm's patch prefix."""
    jc, tc, jp, tp = _case(name, variant)
    batch = _batch(tc, seed=2)
    feed = np.random.RandomState(3).randint(0, tc.vocab, size=(B, 4))
    _, jcache = _j_prefill(jp, jc, _j(batch), cache_len=24)
    _, tcache = TM.prefill(tp, tc, _t(batch), cache_len=24)
    for s in range(feed.shape[1]):
        jl, jcache = _j_decode(jp, jc, jcache,
                               jnp.asarray(feed[:, s], jnp.int32))
        tl, tcache = TM.decode_step(tp, tc, tcache,
                                    torch.from_numpy(feed[:, s]))
        _close(tl, jl)
    _close(tcache.k, jcache.k)


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_greedy_tokens_match_repro(name, variant):
    """``ServeEngine.generate`` on both sides, a vlm's patches passed
    through: plain greedy tokens equal repro's, and so do the port's robust
    m = 8 tokens under the signflip attack, shared and replicated (repro's
    robustness contract: robust tokens equal the plain ones)."""
    jc, tc, jp, tp = _case(name, variant)
    batch = _batch(tc, seed=4)
    max_len = S + N_NEW + (4 if tc.family == "vlm" else 0)
    want = np.asarray(JEngine(jc, jp, max_len=max_len).generate(
        _j(batch), N_NEW))
    got = ServeEngine(tc, tp, max_len=max_len, device="cpu").generate(
        batch, N_NEW).numpy()
    np.testing.assert_array_equal(got, want)
    for share in (True, False):
        rcfg = RobustDecodeConfig(m=8, estimator="vrmom", K=8,
                                  attack="signflip", alpha=0.25,
                                  share_replica_compute=share)
        got = ServeEngine(tc, tp, max_len=max_len, robust=rcfg,
                          device="cpu").generate(batch, N_NEW).numpy()
        np.testing.assert_array_equal(got, want)


def test_vlm_capacity_counts_the_patch_prefix():
    """repro's capacity check counts the tokens and not the patches
    (``repro/serve/engine.py``, ``_check_capacity`` on
    ``batch["tokens"].shape[1]``): with room for the tokens alone its
    generate runs, its prefill cache keeps ``max_len`` positions while
    ``pos`` counts every one, so the prompt's last positions are dropped
    and each decode step overwrites the last slot. The port counts the
    prefix and raises (ROADMAP.md §C)."""
    jc, tc, jp, tp = _case("phi-3-vision-4.2b", None)
    batch = _batch(tc, seed=5)
    n_patches = tc.vision.n_patches
    short = S + 1  # room for the tokens and 2 new ones, not for the patches
    toks = np.asarray(JEngine(jc, jp, max_len=short).generate(_j(batch), 2))
    assert toks.shape == (B, 2)
    _, jcache = _j_prefill(jp, jc, _j(batch), cache_len=short)
    assert jcache.k.shape[2] == short
    assert int(np.asarray(jcache.pos).ravel()[0]) == S + n_patches > short
    with pytest.raises(ValueError, match="cache slots > max_len"):
        ServeEngine(tc, tp, max_len=short, device="cpu").generate(batch, 2)
    with pytest.raises(ValueError, match="cache slots > max_len"):
        ServeEngine(tc, tp, max_len=short, device="cpu").prefill(batch)
    enough = S + n_patches + N_NEW - 1
    got = ServeEngine(tc, tp, max_len=enough, device="cpu").generate(
        batch, N_NEW).numpy()
    want = np.asarray(JEngine(jc, jp, max_len=enough).generate(
        _j(batch), N_NEW))
    np.testing.assert_array_equal(got, want)
