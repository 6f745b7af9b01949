"""The port's collective count and its dry runs over ranks
(``launch.op_cost``'s ``c10d`` collectives, ``launch.dryrun`` with
``mesh=``, ``report.multipod_status``, ``sweep``'s mesh combos).

The port's counts under a fake process group run in one subprocess
(``_PORT``), so no test worker is left holding a default process group;
``repro``'s step compiles in another (``_REPRO``: 8 host devices, an
``Auto``-axes (8, 1) mesh, ``make_train_step`` lowered and compiled as
``repro.launch.dryrun.dryrun_one`` does, without importing that module:
it sets 512 host devices on import and builds ``Explicit`` meshes).

Against ``repro``'s ``hlo_cost.analyze`` of the reduced qwen3's stacked-rrs
step at 8 workers, one a device: the wire's all-to-all and all-gather
bytes (operand bytes, ``hlo_cost``'s rule) are equal, but for one named
difference, and ``repro`` emits collectives the port does not, each named
here:

* the port's step gathers every rank's loss to take the mean (one f32
  operand a rank: 4 more all-gather bytes, ``train.step._mean_over_ranks``);
* GSPMD partitions ``repro``'s vmapped workers' forward and backward
  (``spmd_axis_name``) with all-gathers, all-reduces and all-to-alls of
  activations, every one under a ``vmap(...)`` op name; the port runs a
  rank's worker whole.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get as tget
from repro_torch.launch import dryrun, report, sweep
from repro_torch.models import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B, T = 8, 8, 128          # ranks, global batch, sequence (reduced qwen3)
LOSS_GATHER = 4              # the port's loss all-gather: one f32 a rank
C10D = ("alltoall_base_", "_allgather_base_", "allreduce_")

_PORT = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch import optim as O
from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import counting, fake_group, trips
from repro_torch.models import model as M
from repro_torch.train.step import make_train_step
out, W, B, T = sys.argv[1], *map(int, sys.argv[2:5])
res = {}
cfg = get("qwen3-1.7b").reduced()
with fake_group(W) as g:
    params = M.init(cfg, torch.Generator(), device="meta")
    opt = O.get(cfg.optimizer, lr=1e-3)
    setup = make_train_step(cfg, W, mode="stacked-rrs", optimizer=opt,
                            device="meta", group=g)
    batch = {"tokens": torch.empty((B, T), dtype=torch.int32,
                                   device="meta")}
    with counting("cuda") as oc:
        setup.step_fn(params, opt.init(params), batch)
    res["reduced"] = dict(coll=oc.cost.coll, n=M.param_count(params),
                          c10d={k: v for k, v in oc.by_op.items()
                                if k in %r})
    x = torch.empty((3, 5), device="meta")
    with counting("cuda", reckon=True) as oc:
        for _ in trips(3):
            dist.all_reduce(x, group=g)
    res["trips"] = dict(coll=oc.cost.coll, bytes=oc.cost.bytes,
                        peak=oc.peak)
    m = lambda *s: torch.empty(s, device="meta")
    with counting("cuda") as oc:
        dist.all_to_all_single(m(W, 3), m(W, 3), group=g)
        dist.all_to_all([m(3) for _ in range(W)], [m(3) for _ in range(W)],
                        group=g)
        dist.all_gather_into_tensor(m(W * 3), m(3), group=g)
        dist.all_gather([m(3) for _ in range(W)], m(3), group=g)
        dist.all_reduce(m(3), group=g)
        dist.reduce_scatter_tensor(m(3), m(W * 3), group=g)
        dist.reduce_scatter(m(3), [m(3) for _ in range(W)], group=g)
        dist.send(m(3), dst=1, group=g)
    res["kinds"] = dict(coll=oc.cost.coll, by_op={
        k: v for k, v in oc.by_op.items() if k != "empty"})
    try:
        with fake_group(2):
            pass
        res["nested"] = "no error"
    except RuntimeError as e:
        res["nested"] = str(e)
res["held_after"] = dist.is_initialized()
res["records"] = {}
for name in ("16x16", "2x16x16"):
    r = dryrun.dryrun_one("qwen3-1.7b", "train_4k",
                          mesh=dryrun.MESHES[name], verbose=False)
    dryrun.write_metrics_jsonl(r, out + "/metrics.jsonl")
    res["records"][name] = r
res["records"]["1xH100"] = dryrun.dryrun_one("qwen3-1.7b", "train_4k",
                                             verbose=False)
res["held_after_dryruns"] = dist.is_initialized()
with open(out + "/port.json", "w") as f:
    json.dump(res, f)
print("PORT-COUNTS-OK")
""" % (C10D,)

_REPRO = """
import json, re, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
import repro.optim as O
from repro.configs import get
from repro.dist import sharding as S
from repro.launch import hlo_cost
from repro.models import model as M
from repro.train.step import make_train_step
W, B, T = map(int, sys.argv[1:4])
cfg = get("qwen3-1.7b").reduced()
mesh = jax.make_mesh((W, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
stand = lambda shapes, sh: jax.tree.map(
    lambda l, s: jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=s),
    shapes, sh)
setup = make_train_step(cfg, mesh, mode="stacked-rrs")
ps = M.abstract_init(cfg)
psh = named(S.param_specs(ps, mesh))
opt = O.get(cfg.optimizer, lr=1e-3)
osh = named(setup.opt_specs)
specs = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
hlo = jax.jit(setup.step_fn, donate_argnums=(0, 1),
              out_shardings=(psh, osh, None)).lower(
    stand(ps, psh), stand(jax.eval_shape(opt.init, ps), osh),
    stand(specs, named(S.batch_specs(specs, setup.batch_axes))),
    jax.ShapeDtypeStruct((2,), jnp.uint32)).compile().as_text()
entry = re.search(r"^ENTRY %?([\\w.\\-]+)", hlo, re.M).group(1)
wire, wire_comps, others = {}, set(), {}
for comp, ops in hlo_cost.parse(hlo).items():
    for op in ops.values():
        kind = next((c for c in hlo_cost._COLLECTIVES if op.kind == c
                     or op.kind.startswith(c + "-")), None)
        if kind is None:
            continue
        m = re.search(r'op_name="([^"]*)"', op.rest)
        name = m.group(1) if m else ""
        if "/shard_map/" in name:
            wire_comps.add(comp)
            wire[kind] = wire.get(kind, 0.0) + sum(
                hlo_cost._shape_bytes(ops[n].shape)
                for n in hlo_cost._operand_names(op.rest) if n in ops)
        else:
            others.setdefault(kind, set()).add(name.split("/")[1][:5])
print(json.dumps(dict(total=hlo_cost.analyze(hlo)["collectives"], wire=wire,
                      wire_in_entry=wire_comps == {entry},
                      others={k: sorted(v) for k, v in others.items()},
                      n=sum(x.size for x in jax.tree.leaves(ps)))))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _PORT, str(out), str(W),
                        str(B), str(T)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0 and "PORT-COUNTS-OK" in r.stdout, \
        r.stderr[-3000:]
    with open(out / "port.json") as f:
        res = json.load(f)
    res["metrics"] = str(out / "metrics.jsonl")
    return res


@pytest.fixture(scope="module")
def repro_hlo():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={W}")
    r = subprocess.run([sys.executable, "-c", _REPRO, str(W), str(B),
                        str(T)], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_wire_collectives_match_repro_hlo_cost(port, repro_hlo):
    """The port's all-to-all and all-gather bytes a rank equal ``repro``'s
    wire (its ``shard_map``'s collectives, in the entry computation, so
    counted once) at ``hlo_cost``'s operand rule, the port's loss gather
    named apart; both count the same parameters."""
    got, want = port["reduced"], repro_hlo
    assert got["n"] == want["n"] == 361216
    assert want["wire_in_entry"]
    c = -(-got["n"] // W)
    assert want["wire"] == {"all-to-all": W * c * 4, "all-gather": c * 4}
    assert got["coll"]["all-to-all"] == want["wire"]["all-to-all"]
    assert got["coll"]["all-gather"] == want["wire"]["all-gather"] \
        + LOSS_GATHER
    assert set(got["coll"]) == {"all-to-all", "all-gather"}


def test_repro_only_collectives_are_gspmds_workers(port, repro_hlo):
    """What only ``repro`` emits, by kind: GSPMD's collectives inside the
    vmapped workers (every one under a ``vmap(...)`` op name), and no
    all-reduce in the port's stacked-rrs step."""
    others = repro_hlo["others"]
    assert set(others) == {"all-gather", "all-reduce", "all-to-all"}, others
    assert all(v == ["vmap("] for v in others.values()), others
    for kind, total in repro_hlo["total"].items():
        assert total >= repro_hlo["wire"].get(kind, 0.0), kind
    assert "all-reduce" not in port["reduced"]["coll"]


def test_c10d_ops_counted_with_their_bytes(port):
    """Each collective's output counts twice in ``bytes`` (``hlo_cost``'s
    rule for any op), its operands into ``coll``; ``trips`` multiplies a
    collective like any op, and it allocates nothing."""
    n, ops = port["reduced"]["n"], port["reduced"]["c10d"]
    c = -(-n // W)
    assert ops["alltoall_base_"] == [1, 0, 2 * W * c * 4]
    assert ops["_allgather_base_"] == [2, 0, 2 * (W * c * 4 + W * 4)]
    assert "allreduce_" not in ops
    t = port["trips"]
    assert t["coll"] == {"all-reduce": 3 * 15 * 4}
    assert t["bytes"] == 3 * 2 * 15 * 4 and t["peak"] == 0


def test_each_collective_by_hlo_costs_kind(port):
    """Every ``c10d`` op of ``torch.distributed``'s collectives, two forms
    of each kind but the permute: the operands into ``coll`` (an
    all-gather's shard, an all-to-all's and a reduce-scatter's whole
    input), twice the tensor written into ``bytes`` (a send writes
    none)."""
    f = 3 * 4                              # one [3] f32 tensor
    k = port["kinds"]
    assert k["coll"] == {"all-to-all": 2 * W * f, "all-gather": 2 * f,
                         "all-reduce": f, "reduce-scatter": 2 * W * f,
                         "collective-permute": f}
    assert k["by_op"] == {
        "alltoall_base_": [1, 0, 2 * W * f], "alltoall_": [1, 0, 2 * W * f],
        "_allgather_base_": [1, 0, 2 * W * f],
        "allgather_": [1, 0, 2 * W * f], "allreduce_": [1, 0, 2 * f],
        "_reduce_scatter_base_": [1, 0, 2 * f],
        "reduce_scatter_": [1, 0, 2 * f], "send": [1, 0, 0]}


def test_fake_group_is_left_and_refuses_a_held_group(port):
    assert "already holds a default process group" in port["nested"]
    assert port["held_after"] is False
    assert port["held_after_dryruns"] is False


@pytest.mark.parametrize("mesh,ranks", [("16x16", 16), ("2x16x16", 32)])
def test_mesh_dryrun_record(port, mesh, ranks):
    """One rank of the mesh's worker axes: the RRS wire's all-to-all of the
    padded raveled gradient and all-gather of its slice (plus the loss
    gather), priced at NVLink; the record names the ranks and says the
    model axis is not sharded."""
    res = port["records"][mesh]
    n = TM.param_count(TM.init(tget("qwen3-1.7b"), torch.Generator(),
                               device="meta"))
    c = -(-n // ranks)
    assert res["mesh"] == f"{'2x' if ranks == 32 else ''}16xH100"
    assert res["chips"] == ranks
    assert res["model_axis_sharded"] is False
    assert res["mode"] == "stacked-rrs"
    assert res["collectives"] == {"all-to-all": ranks * c * 4,
                                  "all-gather": c * 4 + LOSS_GATHER}
    assert res["collective_bytes_per_chip"] == sum(
        res["collectives"].values()) > 0
    assert res["collective_s"] == res["collective_bytes_per_chip"] \
        / dryrun.H100_NVLINK_BW
    assert res["compute_s"] == res["flops_per_chip"] / dryrun.H100_PEAK_FLOPS
    cfg = tget("qwen3-1.7b")
    assert math.isclose(res["model_flops_per_chip"],
                        dryrun.model_flops(cfg, dryrun.INPUT_SHAPES[
                            "train_4k"]) / ranks)
    per_rank = 256 // ranks            # sequences a rank, one a micro-step
    n_fwd = 2 if cfg.remat else 1
    assert res["kernels"] == {"aggregate": 1, "flash_attention":
                              per_rank * cfg.n_layers * n_fwd}
    assert res["peak_memory_bytes"] == (res["argument_bytes"]
                                        + res["temp_bytes"]
                                        + res["output_bytes"])


def test_one_card_record_keeps_no_collectives(port):
    res = port["records"]["1xH100"]
    assert res["mesh"] == "1xH100" and res["chips"] == 1
    assert res["collective_bytes_per_chip"] == 0 and res["collectives"] == {}
    assert res["collective_s"] == 0.0 and "model_axis_sharded" not in res


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_mesh_refuses_serving_shapes(shape):
    with pytest.raises(ValueError, match="ROADMAP A5e"):
        dryrun.dryrun_one("qwen3-1.7b", shape, mesh=dryrun.MESHES["16x16"],
                          verbose=False)


def test_multipod_status_tables_the_records(port):
    res = report.load_jsonl(port["metrics"])
    assert set(res) == {("qwen3-1.7b", "train_4k", "16xH100"),
                        ("qwen3-1.7b", "train_4k", "2x16xH100")}
    lines = report.multipod_status(res).splitlines()
    assert lines[0] == "| arch | " + " | ".join(report.ORDER_SHAPES) + " |"
    assert lines[1] == "|" + "---|" * 5
    assert len(lines) == 2 + len(report.ORDER_ARCHS)
    assert "| qwen3-1.7b | ok | - | - | - |" in lines
    assert "| llama3-405b | - | - | - | - |" in lines


def test_report_main_prints_the_three_tables(port, tmp_path, capsys):
    report.main(["--dir", str(tmp_path), "--jsonl", port["metrics"],
                 "--md"])
    out = capsys.readouterr().out
    assert "16xH100" in out and "2x16xH100" in out
    row = [ln for ln in out.split("## Roofline (one of the 16")[1]
           .splitlines() if ln.startswith("| qwen3-1.7b | train_4k |")]
    assert len(row) == 1 and "MISSING" not in row[0]
    assert "| qwen3-1.7b | ok | - | - | - |" in out


def test_sweep_mesh_combos(tmp_path):
    assert len(list(sweep.mesh_combos())) == 20
    assert len(list(sweep.mesh_combos(include_multipod=False))) == 10
    assert {s for _, s, _ in sweep.mesh_combos()} == {"train_4k"}
    status, path = sweep.run_one("qwen3-1.7b", "train_4k", str(tmp_path),
                                 lambda a, s: {"arch": a}, mesh="2x16x16")
    assert status.startswith("ok(")
    assert path.endswith("qwen3-1.7b__train_4k__2x16xH100.json")


def test_metrics_dump_folds_the_port_records(port):
    """``scripts/metrics_dump.py``, unedited, on the port's mesh dry runs'
    ``--metrics-jsonl`` records: ``launch.compile_collective_bytes`` is
    folded in (gauges last-wins: the 2x16x16 record's)."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "metrics_dump.py"),
         port["metrics"], "--format", "json"], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    gauges = json.loads(r.stdout)["gauges"]
    last = port["records"]["2x16x16"]
    assert gauges["launch.compile_collective_bytes"] == \
        last["collective_bytes_per_chip"] > 0
    assert gauges["launch.compile_flops"] == last["flops_per_chip"]
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "metrics_dump.py"),
         port["metrics"]], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0 and "compile_collective_bytes" in r.stdout
