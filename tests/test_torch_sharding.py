"""The port's mesh spec layer (``launch.mesh``, ``dist.sharding``,
``dist.ctx``'s mesh half, ``serve.cache.slot_dims`` / ``pool_specs``,
``train.step.make_serve_steps``) against ``repro``'s, entry for entry.

Every rule is a function of shapes and mesh sizes, so both sides run on
shapes alone at full size, for the 10 configs: ``repro``'s on
``jax.eval_shape`` trees over a ``jax.sharding.AbstractMesh`` with
``Auto`` axes (no devices), the port's on ``convert.expected_shapes`` and
meta tensors over a ``MeshShape``. Meshes (4, 2), (8, 1), (16, 16) and
(2, 16, 16). A port spec is a tuple, a ``repro`` spec a ``PartitionSpec``
with the same entries.

The caches differ in layout, not in rule: ``repro``'s hybrid groups its
mamba states ``[G, every, B, ...]`` and ``[tail, B, ...]`` where the
port's are ``[n_layers, B, ...]``, and ``repro``'s positions are ``[L]``
(``[L, n_slots]`` in a pool) where the port's are one ``[rows]`` vector.
So the row tensors are compared field by field after their layer-stack
dims (which both leave replicated), and the port's positions are held
replicated.

The last test pins ROADMAP §C's mesh fault: under jax 0.9.0 ``repro``'s
RRS on a plain ``jax.make_mesh`` mesh raises (its axes are ``Explicit``),
and the same call on ``Auto`` axes runs (a subprocess with 8 host
devices; nothing of ``repro`` is edited).
"""
import functools
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro import optim as JO
from repro.configs import get as jget
from repro.configs.base import InputShape as JShape
from repro.configs.base import input_specs as j_input_specs
from repro.dist import ctx as JCTX
from repro.dist import sharding as JS
from repro.models import model as JM
from repro.serve import cache as JC
from repro.train.step import make_serve_steps as j_serve_steps
from repro_torch import optim as TO
from repro_torch.configs import get as tget, list_archs
from repro_torch.configs.base import InputShape as TShape
from repro_torch.configs.base import input_specs as t_input_specs
from repro_torch.convert import expected_shapes
from repro_torch.dist import ctx as TCTX
from repro_torch.dist import sharding as TS
from repro_torch.launch.mesh import (MeshShape, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import model as TM
from repro_torch.serve import cache as TC
from repro_torch.train.step import make_serve_steps as t_serve_steps
from repro_torch.tree import paths, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(list_archs())
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 8, 256, 512)
CACHE_LEN = 32768           # decode_32k's
POOL_SLOTS = (8, 256)


def _meshes(name):
    sizes, names = MESHES[name]
    return (AbstractMesh(sizes, names, axis_types=(AxisType.Auto,)
                         * len(sizes)), MeshShape(names, sizes))


def _flat_j(tree):
    """(key path, spec entries) of a ``repro`` spec tree, in flatten
    order."""
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out.append((tuple(getattr(k, "key", getattr(k, "name", k))
                          for k in path), tuple(s)))
    return out


def _flat_t(tree):
    return [(p, tuple(s)) for p, s in paths(tree)]


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    cfg = jget(arch)
    return cfg, jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _topt(arch, name):
    cfg = tget(arch)
    params = tree_map(lambda s: torch.empty(s, device="meta"),
                      expected_shapes(cfg))
    return params, TO.get(name).init(params)


@functools.lru_cache(maxsize=None)
def _jopt(arch, name):
    cfg, shapes = _jparams(arch)
    return jax.eval_shape(JO.get(name).init, shapes)


def _worker_axes(tmesh):
    return tuple(a for a in ("pod", "data") if a in tmesh.axis_names)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_shapes_match_repro():
    """``make_production_mesh`` / ``make_host_mesh`` give ``repro``'s axis
    names and sizes (``repro``'s need devices: its source is read)."""
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshShape(
        ("pod", "data", "model"), (2, 16, 16))
    assert make_host_mesh() == MeshShape(("data", "model"), (4, 2))
    assert make_host_mesh(2, 2, pod=2) == MeshShape(
        ("pod", "data", "model"), (2, 2, 2))
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    src = open(os.path.join(REPO, "src/repro/launch/mesh.py")).read()
    assert "shape = (2, 16, 16) if multi_pod else (16, 16)" in src
    assert 'axes = ("pod", "data", "model") if multi_pod else ' \
           '("data", "model")' in src


def test_device_mesh_needs_a_group():
    from repro_torch.launch.mesh import device_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(make_host_mesh(), "cpu")


# ---------------------------------------------------------------------------
# params, stacked grads, optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_stacked_grad_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    _, jshapes = _jparams(arch)
    tshapes = expected_shapes(tget(arch))
    jspec = JS.param_specs(jshapes, jm)
    tspec = TS.param_specs(tshapes, tm)
    assert _flat_t(tspec) == _flat_j(jspec)
    wa = _worker_axes(tm)
    assert _flat_t(TS.stacked_grad_specs(tspec, wa, tm)) == _flat_j(
        JS.stacked_grad_specs(jspec, wa, jm))
    # meta tensors give the same specs as shape tuples
    meta = tree_map(lambda s: torch.empty(s, device="meta"), tshapes)
    assert TS.param_specs(meta, tm) == tspec


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_repro(arch, mesh, opt):
    jm, tm = _meshes(mesh)
    _, jshapes = _jparams(arch)
    tparams, tstate = _topt(arch, opt)
    jspec = JS.opt_state_specs(_jopt(arch, opt), jshapes,
                               JS.param_specs(jshapes, jm))
    tspec = TS.opt_state_specs(tstate, tparams, TS.param_specs(tparams, tm))
    assert _flat_t(tspec) == _flat_j(jspec)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_batch_axes_and_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    for gb in BATCHES:
        axes = TS.batch_axes_for(tm, gb)
        assert axes == JS.batch_axes_for(jm, gb), gb
        for kind, seq in (("train", 512), ("prefill", 512), ("decode", 512)):
            jb = j_input_specs(jget(arch), JShape("s", seq, gb, kind))
            tb = t_input_specs(tget(arch), TShape("s", seq, gb, kind))
            assert _flat_t(TS.batch_specs(tb, axes)) == _flat_j(
                JS.batch_specs(jb, axes)), (gb, kind)


# ---------------------------------------------------------------------------
# caches and pools
# ---------------------------------------------------------------------------

def _pairs(cfg, tc, jc):
    """(name, the port's leaf, repro's leaf, repro's layer-stack dims
    beyond the port's one) for each row tensor of a decode cache (or of
    its spec or slot-dim tree)."""
    if cfg.family == "hybrid":
        out = [("k", tc.k, jc.attn_g.k, 0), ("v", tc.v, jc.attn_g.v, 0)]
        for f in ("h", "conv", "conv_bc"):
            out.append((f, getattr(tc, f), getattr(jc.mamba_g, f), 1))
            if jc.mamba_t is not None:
                out.append((f + " (tail)", getattr(tc, f),
                            getattr(jc.mamba_t, f), 0))
        return out
    if cfg.family == "encdec":
        return [("k", tc.k, jc.self_kv.k, 0), ("v", tc.v, jc.self_kv.v, 0),
                ("ck", tc.ck, jc.cross_kv.k, 0),
                ("cv", tc.cv, jc.cross_kv.v, 0)]
    return [(f, getattr(tc, f), getattr(jc, f), 0) for f in tc._fields
            if f != "pos" and getattr(tc, f) is not None]


def _same_rows(cfg, tspec, jspec, tshape=None, jshape=None):
    """Each row tensor's spec equal after its layer dims, which both
    leave replicated; the port's positions replicated."""
    pairs = _pairs(cfg, tspec, jspec)
    assert pairs
    if tshape is not None:   # the port lays out what repro does
        for name, t, j, extra in _pairs(cfg, tshape, jshape):
            assert tuple(t.shape)[1:] == tuple(j.shape)[1 + extra:], name
    for name, t, j, extra in pairs:
        t, j = tuple(t), tuple(j) + (None,) * (len(t) + extra - len(j))
        assert t[0] is None and all(e is None for e in j[:1 + extra]), name
        assert t[1:] == j[1 + extra:], (name, t, j)
    assert tuple(tspec.pos) == (None,)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget(arch), tget(arch)
    for gb in BATCHES:
        axes = TS.batch_axes_for(tm, gb)
        jshape = jax.eval_shape(lambda: JM.init_cache(jcfg, gb, CACHE_LEN))
        tshape = TM.init_cache(tcfg, gb, CACHE_LEN, device="meta")
        for g in (gb, None):
            _same_rows(tcfg, TS.cache_specs(tcfg, tshape, tm, axes, g),
                       JS.cache_specs(jcfg, jshape, jm, axes, g),
                       tshape, jshape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_specs_and_slot_dims_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget(arch), tget(arch)
    for n in POOL_SLOTS:
        axes = TS.batch_axes_for(tm, n)
        jpool = jax.eval_shape(lambda: JC.init_pool(jcfg, n, CACHE_LEN))
        tpool = TC.init_pool(tcfg, n, CACHE_LEN, device="meta")
        js, ts = JC.pool_specs(jcfg, jpool, jm, axes), \
            TC.pool_specs(tcfg, tpool, tm, axes)
        _same_rows(tcfg, ts.caches, js.caches, tpool.caches, jpool.caches)
        assert ts.lengths == tuple(js.lengths) == (None,)
        assert ts.active == tuple(js.active) == (None,)
    jd = JC.slot_dims(lambda k: JC._pool_caches(jcfg, k, CACHE_LEN))
    td = TC.slot_dims(lambda k: TC.pool_caches(tcfg, k, CACHE_LEN,
                                               device="meta"))
    for name, t, j, extra in _pairs(tcfg, td, jd):
        assert (t, j) == (1, 1 + extra), name
    assert td.pos == 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget(arch), tget(arch)
    for gb in (8, 128):
        *_, jcs, jspecs, jaxes = j_serve_steps(
            jcfg, jm, shape=JShape("decode_32k", CACHE_LEN, gb, "decode"))
        *_, tcs, tspecs, taxes = t_serve_steps(
            tcfg, tm, shape=TShape("decode_32k", CACHE_LEN, gb, "decode"))
        assert taxes == jaxes
        _same_rows(tcfg, tspecs(), jspecs(), tcs(), jcs())


def test_serve_steps_run_under_the_mesh():
    """``prefill_fn`` / ``decode_fn`` are the model's prefill (last
    position) and decode step, run with the mesh ambient."""
    cfg = tget("qwen3-1.7b").reduced()
    mesh = make_host_mesh()
    params = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prefill_fn, decode_fn, *_ = t_serve_steps(
        cfg, mesh, shape=TShape("s", 16, 2, "decode"))
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    seen = []
    real = TM.decode_step

    def spy(*a, **k):
        seen.append(TCTX.current_mesh())
        return real(*a, **k)

    logits, caches = prefill_fn(params, {"tokens": tokens})
    want, wcaches = TM.prefill(params, cfg, {"tokens": tokens},
                               cache_len=16, last_only=True)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits[:, -1], dim=-1)
    TM.decode_step = spy
    try:
        got, _ = decode_fn(params, caches, tok)
    finally:
        TM.decode_step = real
    assert seen == [mesh] and TCTX.current_mesh() is None
    assert torch.equal(got, TM.decode_step(params, cfg, wcaches, tok)[0])


# ---------------------------------------------------------------------------
# the ambient context
# ---------------------------------------------------------------------------

_ENTRIES = [None, "data", "model", "pod", ("pod", "data"), ("data",),
            ("data", "model"), "expert", ("expert", "model")]


def _u(e, jU, tU):
    return "U" if e is jU or e is tU else e


@pytest.mark.parametrize("mesh", list(MESHES))
def test_clean_entry_and_axis_size_match_repro(mesh):
    jm, tm = _meshes(mesh)
    for entry in _ENTRIES + [JCTX.U]:
        tentry = TCTX.U if entry is JCTX.U else entry
        for dim in (1, 2, 4, 6, 8, 16, 24, 32, 48, 64, 100, 2048):
            want = JCTX._clean_entry(jm, entry, dim)
            got = TCTX._clean_entry(tm, tentry, dim)
            assert _u(got, JCTX.U, TCTX.U) == _u(want, JCTX.U, TCTX.U), (
                entry, dim)
    with JCTX.mesh_context(jm), TCTX.mesh_context(tm):
        for a in ("pod", "data", "model", "expert"):
            assert TCTX.axis_size(a) == JCTX.axis_size(a), a
        x = torch.zeros(8, 16)
        assert TCTX.constrain(x, "data", "model") is x
    assert TCTX.axis_size("data") == 1 and TCTX.current_mesh() is None


# ---------------------------------------------------------------------------
# ROADMAP §C: repro's plain make_mesh fails its RRS under jax 0.9.0
# ---------------------------------------------------------------------------

_MESH_FAULT = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.dist import robust_reduce as RR
from repro.kernels import ref as kref
g = {"b": jnp.asarray(np.random.default_rng(0).standard_normal((4, 7)),
                      jnp.float32)}
plain = jax.make_mesh((4, 2), ("data", "model"))
try:
    jax.jit(lambda t: RR.aggregate_stacked_rrs(t, plain, ("data",),
                                               "vrmom"))(g)
    print("PLAIN-RAN")
except ValueError as e:
    print("PLAIN-RAISED", "Auto" in str(e))
auto = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = jax.jit(lambda t: RR.aggregate_stacked_rrs(t, auto, ("data",),
                                                 "vrmom"))(g)
want = kref.ref_vrmom(g["b"], K=10)
print("AUTO-DIFF", float(jnp.max(jnp.abs(out["b"] - want))))
"""


def test_repro_plain_make_mesh_fault_pinned():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _MESH_FAULT],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.split("\n")
    assert "PLAIN-RAISED True" in lines, r.stdout
    # within the reference's own RRS-vs-ref tolerance (2e-5,
    # tests/test_distributed.py::test_robust_rrs_matches_ref)
    diff = float(next(s for s in lines
                      if s.startswith("AUTO-DIFF")).split()[1])
    assert diff <= 2e-5, r.stdout
