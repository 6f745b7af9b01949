"""repro_torch checkpoints cross with ``repro``'s both ways: the same
``arrays.npz`` + ``tree.json`` format, leaves in JAX's flatten order (dict
keys sorted), bf16 as uint16 bits. Every comparison is bitwise."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import optim as JO
from repro.configs import get as j_get_arch
from repro.models import model as JM
from repro_torch import checkpoint as TC
from repro_torch import optim as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.models import model as TM
from repro_torch.tree import leaves as _leaves

# bf16 values a float32 round trip would mangle: signed zeros, infs,
# the bf16 max, subnormal-adjacent
EXTREMES = np.array([0.0, -0.0, np.inf, -np.inf, 3.3895314e38, 1e-38,
                     -1e-38], np.float32)


def _bits(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), list(_leaves(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name
        np.testing.assert_array_equal(_bits(b), _bits(a))


def _models(dtype):
    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    if dtype == "bfloat16":
        import dataclasses

        jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=dtype)
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_repro(tmp_path, dtype):
    """Params and an AdamW state written by the port restore in ``repro``
    into ``repro``'s own tree, bit for bit."""
    jcfg, tcfg = _models(dtype)
    tp = TM.init(tcfg, torch.Generator().manual_seed(1), device="cpu")
    topt = TO.get("adamw", lr=1e-2)
    ts = topt.init(tp)
    g = jax.tree.map(lambda x: torch.full_like(x, 0.01), tp)
    topt.update(g, ts, tp)
    TC.save(str(tmp_path / "ck"), {"params": tp, "opt": ts})
    jp = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    like = {"params": jp, "opt": JO.get("adamw").init(jp)}
    out = JC.restore(str(tmp_path / "ck"), like)
    _same(out, {"params": tp, "opt": ts})
    assert int(out["opt"]["step"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repro_checkpoint_restores_in_port(tmp_path, dtype):
    jcfg, tcfg = _models(dtype)
    jp = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    jopt = JO.get("adafactor", lr=1e-2)
    js = jax.jit(jopt.init)(jp)
    js = jax.jit(jopt.update)(jax.tree.map(lambda x: jnp.full_like(x, 0.01),
                                           jp), js, jp)[1]
    JC.save(str(tmp_path / "ck"), {"params": jp, "opt": js})
    tp = TM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    like = {"params": tp, "opt": TO.get("adafactor").init(tp)}
    out = TC.restore(str(tmp_path / "ck"), like)
    _same({"params": jp, "opt": js}, out)
    assert sorted(out) == ["opt", "params"]
    assert out["opt"]["step"].dtype == torch.int32


def test_extreme_bf16_values_cross_both_ways(tmp_path):
    j = {"x": jnp.asarray(EXTREMES).astype(jnp.bfloat16),
         "n": {"i": jnp.arange(5, dtype=jnp.int32)}}
    JC.save(str(tmp_path / "a"), j)
    like = {"x": torch.zeros(7, dtype=torch.bfloat16),
            "n": {"i": torch.zeros(5, dtype=torch.int32)}}
    t = TC.restore(str(tmp_path / "a"), like)
    _same(j, t)
    TC.save(str(tmp_path / "b"), t)
    back = JC.restore(str(tmp_path / "b"), jax.tree.map(jnp.zeros_like, j))
    _same(back, t)
    again = TC.restore(str(tmp_path / "b"), like)
    _same(j, again)
