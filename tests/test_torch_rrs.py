"""The Robust-Reduce-Scatter wire and the consensus wire over
``torch.distributed`` (``dist.robust_reduce.aggregate_stacked_rrs``,
``dist.consensus.aggregate_stacked_consensus``, ``robust_dot`` and
``make_train_step`` over a group, RL201) on ``gloo`` groups of 4 and of
8 CPU ranks.

Each group size is one spawn (``tests/test_torch_rrs_ranks.py``): the
ranks meet through a ``FileStore`` under pytest's tmp dir (pytest runs
with ``-n 6``, so no fixed port), run every check, and write each check's
result; the cases below read them. Held:

* the wire bit for bit against the port's ``aggregate_stacked_auto``
  (vrmom at K 3 and 10, mom, median, trimmed mean, B1's mean; f32 and
  bf16 leaves; ``repro``'s 29-coordinate tree, which the padding serves; two
  rows a rank), its ``with_diag`` moments against ``tree_diagnose`` at
  1e-6 with the suspected mask exact, every coordinate-wise attack on a
  rank's slice against the same attack on the stack, and the aggregate the
  same on every rank. The mean on its default ``ref`` backend
  (``torch.mean``) sums in an order that follows the stack's layout, so
  the slice and the leaf agree to f32 rounding, held at 1e-6;
* the refusals (``GroupRefusal`` for a world size that does not divide
  the workers, the modes, estimators and attacks the RRS wire does not
  take, the consensus backend at other than one worker a rank or with
  ``inloop``; ``ValueError`` for a whole-vector estimator and for n <= 5f);
* on 8 ranks (f = 1), the consensus wire bit for bit against the port's
  emulation ``consensus_aggregate`` on the gathered stack with the same
  draws, values and all six ``ConsensusAux`` fields, for the ``mean`` and
  ``midpoint`` trims under four plans (fault-free; dropout 0.2 with a crash
  at round 1; two stragglers; a pinned omniscient row, attacked on the
  wire), in blocks of 512 columns with its ``all_gather`` calls counted (a
  block: 1 settled, ``p_end + 1`` otherwise); fault-free it equals the RRS
  wire bit for bit; ``with_diag`` against the one-process ``aggregate``
  (moments at 1e-6). The consensus train step over the 8 ranks (reduced
  qwen3, one Byzantine worker, dropout 0.1, 6 rounds) equals the
  one-process step bit for bit, params, loss and aux: two steps under
  alie, one under mimic and one under gaussian, whose draws and victim
  need the whole stack the wire gathers;
* one ``robust_dot`` ``dW`` over the group against the one-process
  ``_RobustDot`` bit for bit;
* two train steps over the group of 4 against the one-process step on the
  same batches (reduced qwen3, signflip on the last rank's worker):
  ``stacked-rrs`` under AdamW bit for bit, loss included; ``inloop`` under
  SGD: the leaves whose every product rides the wire bit for bit after
  step 1, and every leaf within 1e-6 after both steps. The inloop step
  sums the ranks' partial gradients of the norms and the embedding lookup
  (one f32 ``all_reduce`` a leaf), where one process sums all the rows in
  one reduction: the order of that sum differs (ROADMAP §C). Params are
  identical on every rank after each step. One more inloop step, each
  layer checkpointed, sums only those leaves (the products' ``dW`` come
  off the wire as the aggregate on every rank): the ``all_reduce`` calls
  are counted leaf by leaf;
* RL201 ``ok`` on the group, and ``to_named`` on a ``DeviceMesh``.

Against ``repro``: its RRS on an ``Auto``-axes (4, 2) host mesh in a
subprocess (8 host devices), on the same numpy arrays as the 4-rank
wire, within 1e-5 in f32 (``repro``'s own RRS-vs-oracle test uses 2e-5);
its ``shard_map`` consensus wire on an ``Auto``-axes (8, 1) mesh against
the 8-rank wire, the ranks handed ``repro``'s uniforms as ``draws``:
midpoint exact, mean within 1e-6 relative, aux exact (and, in that
subprocess, the body of ``tests/test_consensus.py``'s mesh test).
And ``launch.train`` under ``torchrun`` with 4 CPU ranks logs a finite
loss on every rank.
"""
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_rrs_ranks as RK
from repro_torch.core import attacks as atk
from repro_torch.dist import robust_reduce as RR
from repro_torch.tree import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names(world):
    names = [f"wire[{n}]" for n in RK.WIRE_ESTIMATORS]
    names += ["wire[mean_ref]", "wire[29_coordinates]",
              "wire[two_rows_a_rank]", "diag"]
    names += [f"attack[{n}]" for n in atk.COORDINATEWISE]
    names += [f"refuse[{n}]" for n in (
        "whole_vector_estimator", "workers_not_divided",
        "robust_backward_not_divided", "mode_stacked_auto", "mode_mean",
        "adaptive", "consensus_two_rows_a_rank", "consensus_wire_two_rows",
        "consensus_n_le_5f", "consensus_inloop", "aggregate_stacked_auto",
        "attack_mimic", "attack_bitflip", "attack_gaussian")]
    if world == 8:
        names += [f"consensus[{t}_{p}]" for t in RK.CONS_TRIMS
                  for p in RK.CONS_PLANS]
        names += ["consensus[fault_free_equals_rrs]", "consensus[diag]",
                  "consensus[repro_saved]", "train[consensus_runs]"]
        names += [f"train[consensus_{a}]" for a, _, _ in RK.CONS_TRAIN]
    names += ["robust_dot", "rl201", "to_named"]
    if world == 4:
        names += ["train[stacked-rrs]", "train[inloop]",
                  "train[inloop_sums]", "port_rrs_saved"]
        names += [f"coverage[{c}]" for c in RK.COV_CASES]
        names += ["coverage[not_divisible]", "coverage[devices_differ]",
                  "coverage[one_rank_group]", "coverage[small_rep_saved]"]
    return names


_RUNS = {}


def _rrs_input():
    """``tests/test_distributed.py``'s RRS arrays' shapes, from numpy."""
    rng = np.random.default_rng(7)
    return {"w_gate": rng.standard_normal((4, 6, 16), np.float32),
            "b": rng.standard_normal((4, 7), np.float32)}


# repro's consensus test arrays and plan (tests/test_consensus.py:200-245)
CONS_KEY = 11
CONS_PLAN = dict(dropout=0.2, n_crashed=1, crash_round=1)


def _consensus_input():
    """``{"w": [8, 12, 8], "b": [8, 7]}`` from numpy, and ``repro``'s
    uniforms of the plan's rounds under key 11 (``uniform(fold_in(key,
    p), (8, 8))``, as ``tests/test_torch_consensus.py`` draws them)."""
    import jax

    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan

    rng = np.random.default_rng(11)
    p_end = ConsensusConfig(f=1).phases(FaultPlan(**CONS_PLAN))
    key = jax.random.PRNGKey(CONS_KEY)
    draws = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, p), (8, 8))) for p in range(p_end)])
    return {"w": rng.standard_normal((8, 12, 8), np.float32),
            "b": rng.standard_normal((8, 7), np.float32), "draws": draws}


def _run(world, tmp_path_factory):
    """Every rank's results of the ``world``-rank run (one spawn)."""
    if world not in _RUNS:
        path = str(tmp_path_factory.mktemp(f"rrs{world}"))
        np.savez(os.path.join(path, "rrs_input.npz"), **_rrs_input())
        if world == 8:
            np.savez(os.path.join(path, "consensus_input.npz"),
                     **_consensus_input())
        RK.run_ranks(world, path)
        ranks = []
        for r in range(world):
            with open(os.path.join(path, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        _RUNS[world] = (path, ranks)
    return _RUNS[world]


@pytest.mark.parametrize("check", _names(4))
def test_wire_on_4_ranks(check, tmp_path_factory):
    _, ranks = _run(4, tmp_path_factory)
    for r, res in enumerate(ranks):
        status, detail = res[check]
        assert status == "ok", f"rank {r}: {detail}"


@pytest.mark.parametrize("check", _names(8))
def test_wire_on_8_ranks(check, tmp_path_factory):
    _, ranks = _run(8, tmp_path_factory)
    for r, res in enumerate(ranks):
        status, detail = res[check]
        assert status == "ok", f"rank {r}: {detail}"


@pytest.mark.parametrize("name", sorted(atk.REGISTRY))
def test_attack_coordinatewise_split(name):
    """``COORDINATEWISE`` is exactly the attacks that give, on any split of
    a stack's coordinates into pieces, the pieces of the attacked stack
    (what the wire relies on), in f32 and bf16. Each call draws from a
    generator seeded alike."""
    fn = atk.get(name)
    rng = np.random.default_rng(3)
    mask = torch.arange(8) >= 6
    split = True
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.from_numpy(rng.standard_normal((8, 3, 40), np.float32)
                             ).to(dtype)
        gen = lambda: torch.Generator().manual_seed(0)
        whole = fn(gen(), v, mask).reshape(8, -1)
        flat = v.reshape(8, -1)
        for a, b in ((0, 13), (13, 57), (57, 120)):
            piece = fn(gen(), flat[:, a:b].contiguous(), mask)
            split = split and torch.equal(piece, whole[:, a:b])
    assert split == (name in atk.COORDINATEWISE)


def test_one_rank_wire_is_the_stacked_path():
    """Without a group (or on one rank) the wire is
    ``aggregate_stacked_auto``, the attack leaf by leaf."""
    t = RK._tree(np.random.default_rng(5), 6)
    mask = torch.arange(6) >= 5
    sf = atk.get("signflip")
    got = RR.aggregate_stacked_rrs(t, None, "vrmom",
                                   attack=lambda v: sf(None, v, mask))
    hit = tree_map(lambda g: sf(None, g, mask), t)
    assert RK._equal(got, RR.aggregate_stacked_auto(hit, "vrmom"))
    assert RK._equal(RR.aggregate(t, mode="stacked-rrs"),
                     RR.aggregate_stacked_auto(t, "vrmom"))


_REPRO_RRS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.dist import robust_reduce as RR
d = np.load(sys.argv[1])
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
g = {"a": {"w_gate": jnp.asarray(d["w_gate"])}, "b": jnp.asarray(d["b"])}
sh = {"a": {"w_gate": NamedSharding(mesh, P("data", None, "model"))},
      "b": NamedSharding(mesh, P("data", None))}
g = jax.tree.map(jax.device_put, g, sh)
out = jax.jit(lambda t: RR.aggregate_stacked_rrs(t, mesh, ("data",),
                                                 "vrmom"))(g)
np.savez(sys.argv[2], w_gate=np.asarray(out["a"]["w_gate"]),
         b=np.asarray(out["b"]))
print("REPRO-RRS-OK")
"""


def test_wire_matches_repro_rrs(tmp_path_factory):
    path, ranks = _run(4, tmp_path_factory)
    assert ranks[0]["port_rrs_saved"][0] == "ok", ranks[0]["port_rrs_saved"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = os.path.join(path, "repro_rrs.npz")
    r = subprocess.run([sys.executable, "-c", _REPRO_RRS,
                        os.path.join(path, "rrs_input.npz"), out],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "REPRO-RRS-OK" in r.stdout, r.stderr[-3000:]
    want, got = np.load(out), np.load(os.path.join(path, "port_rrs.npz"))
    for k in ("w_gate", "b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


_REPRO_CONSENSUS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.dist import robust_reduce as RR
from repro.dist.consensus import (ConsensusConfig, aggregate_stacked_consensus,
                                  consensus_aggregate)
from repro.dist.faults import FaultPlan
d = np.load(sys.argv[1])
mesh = jax.make_mesh((8, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
g = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
sh = {"w": NamedSharding(mesh, P("data", None, "model")),
      "b": NamedSharding(mesh, P("data", None))}
gp = jax.tree.map(jax.device_put, g, sh)
plan = FaultPlan(dropout=0.2, n_crashed=1, crash_round=1).validate(8)
key = jax.random.PRNGKey(int(sys.argv[3]))
out = {}
for trim in ("mean", "midpoint"):
    cfg = ConsensusConfig(f=1, trim=trim).validate(8)
    res, aux = jax.jit(lambda x: aggregate_stacked_consensus(
        x, mesh, ("data",), "vrmom", config=cfg, plan=plan, key=key))(gp)
    for k in ("w", "b"):
        out[trim + "/" + k] = np.asarray(res[k])
    for f in aux._fields:
        out[trim + "/" + f] = np.asarray(getattr(aux, f))
    # tests/test_consensus.py:200-245, on Auto axes: the faulty wire is
    # the emulation bit for bit
    wire = jnp.concatenate([g["w"].reshape(8, -1), g["b"].reshape(8, -1)],
                           axis=1)
    want, aux_e = consensus_aggregate(wire, "vrmom", config=cfg, plan=plan,
                                      key=key)
    got = jnp.concatenate([res["w"].reshape(-1), res["b"].reshape(-1)])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for f in aux_e._fields:
        np.testing.assert_array_equal(np.asarray(getattr(aux, f)),
                                      np.asarray(getattr(aux_e, f)))
cfg = ConsensusConfig(f=1).validate(8)
free, aux = jax.jit(lambda x: aggregate_stacked_consensus(
    x, mesh, ("data",), "vrmom", config=cfg))(gp)
rrs = jax.jit(lambda x: RR.aggregate_stacked_rrs(x, mesh, ("data",),
                                                 "vrmom"))(gp)
for k in g:
    np.testing.assert_array_equal(np.asarray(free[k]), np.asarray(rrs[k]))
assert not bool(aux.quorum_lost)
np.savez(sys.argv[2], **out)
print("REPRO-CONSENSUS-OK")
"""


def test_consensus_wire_matches_repro(tmp_path_factory):
    """The 8-rank consensus wire on ``repro``'s arrays, plan and uniforms
    against ``repro``'s ``shard_map`` wire on an ``Auto``-axes (8, 1) host
    mesh: the midpoint trim exactly, the trimmed mean within 1e-6 relative
    (XLA sums the kept window in its own order), the six aux fields
    exactly."""
    from repro_torch.dist.consensus import ConsensusAux

    path, ranks = _run(8, tmp_path_factory)
    assert ranks[0]["consensus[repro_saved]"][0] == "ok", \
        ranks[0]["consensus[repro_saved]"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = os.path.join(path, "repro_consensus.npz")
    r = subprocess.run([sys.executable, "-c", _REPRO_CONSENSUS,
                        os.path.join(path, "consensus_input.npz"), out,
                        str(CONS_KEY)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "REPRO-CONSENSUS-OK" in r.stdout, \
        r.stderr[-3000:]
    want, got = np.load(out), np.load(os.path.join(path,
                                                   "port_consensus.npz"))
    for trim in ("mean", "midpoint"):
        for k in ("w", "b"):
            a, b = got[f"{trim}/{k}"], want[f"{trim}/{k}"]
            if trim == "midpoint":
                np.testing.assert_array_equal(a, b)
            else:
                scale = float(np.abs(b).max())
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           atol=1e-6 * scale)
        for f in ConsensusAux._fields:
            np.testing.assert_array_equal(got[f"{trim}/{f}"],
                                          want[f"{trim}/{f}"], err_msg=f)


_REPRO_COVERAGE = """
import json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.infer import coverage_run
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
cell = coverage_run(mesh=mesh, rep_axis="data", **json.loads(sys.argv[1]))
np.savez(sys.argv[2], **{k: np.asarray(getattr(cell, k))
                         for k in cell._fields})
print("REPRO-COVERAGE-OK")
"""


def _cell_summary(d):
    return {"coverage": float(d["covered"].mean()),
            "mean_width": float(d["width"].mean()),
            "rmse": float(np.sqrt(np.mean(d["err"] ** 2))),
            "cis": d["covered"].size}


def test_coverage_over_ranks_matches_repro_mesh_cell(tmp_path_factory):
    """``tests/test_infer.py``'s small-rep cell (40 replications) over the 4
    gloo ranks against ``repro``'s ``coverage_run(mesh=)`` on an
    ``Auto``-axes 4-device host mesh, as distributions (the generators'
    draws differ): each within that test's own bounds, and their coverages
    within 4 binomial standard errors at the nominal 0.95 over the 200
    CIs."""
    path, ranks = _run(4, tmp_path_factory)
    assert ranks[0]["coverage[small_rep_saved]"][0] == "ok", \
        ranks[0]["coverage[small_rep_saved]"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = os.path.join(path, "repro_coverage.npz")
    r = subprocess.run([sys.executable, "-c", _REPRO_COVERAGE,
                        json.dumps(RK.COV_SMALL_REP), out],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "REPRO-COVERAGE-OK" in r.stdout, \
        r.stderr[-3000:]
    cells = {"repro": _cell_summary(np.load(out)),
             "port": _cell_summary(np.load(os.path.join(
                 path, "port_coverage.npz")))}
    for name, s in cells.items():
        assert s["cis"] == 40 * 5, (name, s)
        assert 0.85 <= s["coverage"] <= 1.0, (name, s)
        assert np.isfinite(s["mean_width"]) and s["mean_width"] > 0, (name, s)
        assert s["rmse"] < 0.05, (name, s)
    se = math.sqrt(0.95 * 0.05 / 200)
    assert abs(cells["port"]["coverage"] - cells["repro"]["coverage"]) \
        <= 4 * se, cells


def test_launch_train_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "qwen3-1.7b", "--reduced", "--steps", "2", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    losses = {}
    for m in re.finditer(r"\[rank (\d)/4\] step +(\d+) loss (\S+)",
                         r.stdout):
        losses[(int(m.group(1)), int(m.group(2)))] = float(m.group(3))
    assert sorted(losses) == [(k, s) for k in range(4) for s in (0, 1)], \
        r.stdout
    assert all(math.isfinite(v) for v in losses.values())
    assert "workers=8" in r.stdout and "mode=stacked-rrs" in r.stdout
