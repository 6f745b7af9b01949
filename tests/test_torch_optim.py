"""repro_torch optimizers against ``repro.optim``: the same numpy params
and gradients through three updates of each optimizer, at 1e-6 (absolute
and relative; both compute in f32, in other orders only where a backend
fuses a multiply-add). The port updates in place; ``repro`` returns new
trees. A bf16 value is held within one bf16 step (2^-7 relative) of
``repro``'s: an f32 result within 1e-7 of a rounding boundary may round
either way."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro_torch import optim as TO
from repro_torch.configs import get as t_get_arch
from repro_torch.convert import opt_state_from_jax
from repro_torch.tree import leaves as _leaves

torch.set_num_threads(1)


def _params(dtype=np.float32):
    rs = np.random.RandomState(0)
    return {"w": rs.randn(6, 5).astype(dtype),          # factored
            "b": rs.randn(5).astype(dtype),             # unfactored
            "layers": {"k": rs.randn(3, 4, 2).astype(dtype)}}


def _grads(step):
    rs = np.random.RandomState(100 + step)
    p = _params()
    return jax.tree.map(lambda x: (0.1 * rs.randn(*x.shape)).astype(
        np.float32), p)


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(jt, tt, tol=1e-6):
    jl, tl = jax.tree.leaves(jt), list(_leaves(tt))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)


OPTS = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.1}),
    ("adafactor", {}),
    ("adafactor", {"momentum": 0.0}),
]


@pytest.mark.parametrize("name,kw", OPTS)
def test_three_updates_match_repro(name, kw):
    jopt = JO.get(name, lr=1e-2, **kw)
    topt = TO.get(name, lr=1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, _params())
    js = jopt.init(jp)
    tp = _to_torch(_params())
    ts = topt.init(tp)
    assert sorted(ts) == sorted(js)
    for i in range(3):
        g = _grads(i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts2 = topt.update(_to_torch(g), ts, tp)
        assert tp2 is tp and ts2 is ts   # in place
    _close(jp, tp)
    _close({k: v for k, v in js.items() if k != "step"},
           {k: v for k, v in ts.items() if k != "step"})
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32


def test_bf16_params_within_one_bf16_step():
    jopt, topt = JO.get("adamw", lr=1e-2), TO.get("adamw", lr=1e-2)
    p16 = _params(ml_dtypes.bfloat16)
    jp = jax.tree.map(jnp.asarray, p16)
    js = jopt.init(jp)
    tp = jax.tree.map(lambda x: torch.from_numpy(
        x.view(np.int16).copy()).view(torch.bfloat16), p16)
    ts = topt.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16), _grads(i))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        topt.update(jax.tree.map(lambda x: torch.from_numpy(
            x.view(np.int16).copy()).view(torch.bfloat16), g), ts, tp)
    for a, b in zip(jax.tree.leaves(jp), _leaves(tp)):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.float().numpy(), a, rtol=2 ** -7,
                                   atol=0)
    _close(js["m"], ts["m"])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_continue_from_repro_state(name):
    """Two updates in ``repro``, its state and params converted
    (``convert.opt_state_from_jax``), the third in both packages."""
    from repro_torch.convert import params_from_jax
    from repro.configs import get as j_get_arch
    from repro.models import model as JM

    jcfg = j_get_arch("qwen3-1.7b").reduced()
    tcfg = t_get_arch("qwen3-1.7b").reduced()
    jp = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jopt, topt = JO.get(name, lr=1e-2), TO.get(name, lr=1e-2)
    update = jax.jit(jopt.update)
    js = jax.jit(jopt.init)(jp)
    rs = np.random.RandomState(5)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        0.1 * rs.randn(*x.shape), jnp.float32), jp) for _ in range(3)]
    for g in grads[:2]:
        jp, js = update(g, js, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                            device="cpu")
    assert int(ts["step"]) == 2
    jp, js = update(grads[2], js, jp)
    topt.update(jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                             grads[2]), ts, tp)
    _close(jp, tp)
    _close(js["v"], ts["v"])
    # adafactor's first moment is bf16: within one bf16 step
    for a, b in zip(jax.tree.leaves(js["m"]), _leaves(ts["m"])):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=2 ** -7 if b.dtype == torch.bfloat16
                                   else 1e-6, atol=1e-6)
    assert int(ts["step"]) == 3
