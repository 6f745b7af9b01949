"""repro_torch.launch: the one-card accounting against ``repro``'s.

* ``INPUT_SHAPES`` / ``input_specs`` equal ``repro``'s shapes and dtypes.
* Full-size params, optimizer state and ``decode_32k`` caches on the meta
  device hold exactly ``jax.eval_shape``'s bytes of ``repro``'s.
* ``model_flops_per_chip`` is ``repro``'s 6 (2) · N_active · tokens.
* The trip-count reckoning equals the whole traced step (FLOPs, bytes,
  peak) at reduced qwen3-1.7b, W 4, 8 x 2048, for both targets.
* Each kernel wrapper raises on a meta tensor outside ``counting``; inside
  ``counting("cuda")`` it returns the card's shapes, and its ``cost``
  gives PERF.md §6's bounds.
* ``report`` renders from JSON and from a metrics JSONL; ``sweep``
  resumes and keeps a failing combo's traceback.

The FLOP parity with ``repro``'s HLO cost model is
``tests/test_torch_launch_parity.py``.
"""
import dataclasses
import gc
import importlib
import json
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get as jget
from repro.configs import input_specs as j_input_specs
from repro.models import model as JM
from repro_torch import optim as O
from repro_torch import tree
from repro_torch.configs import (INPUT_SHAPES, InputShape, get as tget,
                                 input_specs, list_archs)
from repro_torch.kernels import build
from repro_torch.kernels import vrmom as VR
from repro_torch.launch import dryrun, op_cost, report, sweep
from repro_torch.launch.op_cost import counting, trips
from repro_torch.models import model as M
from repro_torch.train.step import make_train_step

# the package's names are the wrappers: the modules by their paths
DA = importlib.import_module("repro_torch.kernels.decode_attention")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
ARCHS = list_archs()
H100_BYTES, H100_FLOPS = 3.35e12, 989e12


def _jbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _tbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def test_ten_archs_four_shapes():
    assert len(ARCHS) == 10 and set(ARCHS) == set(sweep.ARCHS) \
        == set(report.ORDER_ARCHS)
    assert set(INPUT_SHAPES) == set(J_SHAPES) == set(sweep.SHAPES) \
        == set(report.ORDER_SHAPES)


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_repro(arch, shape):
    js, ts = J_SHAPES[shape], INPUT_SHAPES[shape]
    assert (ts.name, ts.seq_len, ts.global_batch, ts.kind) == (
        js.name, js.seq_len, js.global_batch, js.kind)
    want = j_input_specs(jget(arch), shape)
    got = input_specs(tget(arch), shape)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).replace("torch.", "") == \
            jnp.dtype(want[k].dtype).name, k


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_bytes_on_meta_match_repro(arch):
    """Params, optimizer state and the decode_32k cache of the full-size
    arch: the port's meta tensors hold exactly the bytes of
    ``jax.eval_shape`` of ``repro``'s."""
    jcfg, tcfg = jget(arch), tget(arch)
    shape = INPUT_SHAPES["decode_32k"]
    jp = JM.abstract_init(jcfg)
    tp = M.init(tcfg, torch.Generator(), device="meta")
    assert _tbytes(tp) == _jbytes(jp)
    assert M.param_count(tp) == sum(int(np.prod(x.shape))
                                    for x in jax.tree.leaves(jp))
    jst = jax.eval_shape(JO.get(jcfg.optimizer, lr=1e-3).init, jp)
    tst = O.get(tcfg.optimizer, lr=1e-3).init(tp)
    assert _tbytes(tst) == _jbytes(jst)
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, shape.global_batch,
                                              shape.seq_len))
    tc = M.init_cache(tcfg, shape.global_batch, shape.seq_len,
                      device="meta")
    # every cache tensor alike; the port's position is one int32 a row
    # ([B], ``model``'s docstring), where ``repro`` keeps one a layer
    jpos = [x for path, x in jax.tree_util.tree_leaves_with_path(jc)
            if "pos" in jax.tree_util.keystr(path)]
    assert _tbytes(_without_pos(tc)) == _jbytes(jc) - _jbytes(jpos)
    assert _tbytes(tc) - _tbytes(_without_pos(tc)) == 4 * shape.global_batch


def _without_pos(cache):
    """The cache's tensors but its ``pos`` fields (caches are NamedTuples,
    a hybrid's and an encdec model's nested)."""
    out = []
    for name, v in cache._asdict().items():
        if hasattr(v, "_asdict"):
            out.append(_without_pos(v))
        elif name != "pos":
            out.append(v)
    return out


def _repro_active(cfg) -> float:
    """``repro.launch.dryrun._active_params``'s formula (that module pins
    512 host devices at import, so it is not imported here)."""
    total = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(JM.abstract_init(cfg)))
    if cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        total -= cfg.n_layers * 3 * e * cfg.d_model * cfg.d_ff * (1 - k / e)
    return float(total)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_repro(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    n = _repro_active(jcfg)
    assert dryrun.active_params(tcfg) == n
    for name, shape in INPUT_SHAPES.items():
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        want = (6.0 if shape.kind == "train" else 2.0) * n * tokens
        assert dryrun.model_flops(tcfg, shape) == want, name


def test_active_params_moe_values():
    """The values the two packages' counts gave when this was ported."""
    assert dryrun.active_params(tget("granite-moe-3b-a800m")) == 882874368
    assert dryrun.active_params(tget("mixtral-8x7b")) == 12748853248


def _reduced_qwen():
    # the reduced config at attn_chunk 512: the plain mha's chunk loop is
    # most of a meta trace's host time, and the reckoning does not depend
    # on the chunk
    return dataclasses.replace(tget("qwen3-1.7b").reduced(), attn_chunk=512)


@pytest.mark.parametrize("target", ["cpu", "cuda"])
def test_trip_count_reckoning_equals_the_whole_step(target):
    cfg = _reduced_qwen()
    p = M.init(cfg, torch.Generator(), device="meta")
    opt = O.get(cfg.optimizer, lr=1e-3)
    st = opt.init(p)
    setup = make_train_step(cfg, 4, optimizer=opt, device="meta")
    batch = input_specs(cfg, InputShape("t", 2048, 8, "train"))
    got = []
    for reckon in (False, True):
        with counting(target, reckon=reckon) as oc:
            setup.step_fn(p, st, batch)
        got.append((oc.cost.flops, oc.cost.bytes, oc.peak,
                    {k: v["calls"] for k, v in oc.kernels.items()},
                    {k: v[:2] for k, v in oc.by_op.items()}))
    assert got[0] == got[1]
    kernels = got[0][3]
    if target == "cuda":
        # 4 workers x 2 micro-steps x 2 layers of B2; B1 on each leaf
        assert kernels == {"flash_attention": 16, "aggregate": 13}
    else:
        assert kernels == {}
    assert got[0][0] > 0 and got[0][1] > 0 and got[0][2] > 0


def test_unflatten_holds_no_cycle():
    """A tree built by ``tree.unflatten`` lets its leaves go as soon as the
    tree goes: before, its self-calling closure kept the flat list (a
    train step's gradients, 3.44 GB at qwen3-1.7b's width) in a reference
    cycle until the collector ran, and the trips of a step differed."""
    gc.collect()
    gc.disable()
    try:
        x = torch.ones(3)
        ref = weakref.ref(x)
        t = tree.unflatten({"b": {"c": 0}, "a": 0}, [x, torch.zeros(1)])
        assert t["a"] is x
        del t, x
        assert ref() is None
    finally:
        gc.enable()


def test_cost_add():
    c = op_cost.Cost(1.0, 2.0, {"all-gather": 3.0})
    c.add(op_cost.Cost(10.0, 20.0, {"all-gather": 1.0, "x": 2.0}), 2)
    assert (c.flops, c.bytes, c.coll) == (21.0, 42.0,
                                          {"all-gather": 5.0, "x": 4.0})


def test_trips_outside_a_reckoning_is_range():
    assert list(trips(3)) == [0, 1, 2]
    with counting("cpu"):
        assert list(trips(3)) == [0, 1, 2]
    with counting("cpu", reckon=True) as oc:
        assert list(trips(3)) == [0]
        assert oc.mult == 1
        for _ in trips(3):
            for _ in trips(5):
                assert oc.mult == 15
                torch.mm(torch.empty(4, 8, device="meta"),
                         torch.empty(8, 2, device="meta"))
    assert oc.cost.flops == 15 * 2 * 4 * 8 * 2


def test_target_cpu_counts_as_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tget("qwen3-1.7b").reduced()
    p = M.init(cfg, torch.Generator(), device="meta")
    b = {"tokens": torch.empty((2, 128), dtype=torch.int32, device="meta")}
    with counting("cpu") as oc:
        M.prefill(p, cfg, b, cache_len=128, last_only=True)
    with FlopCounterMode(display=False) as fc:
        M.prefill(p, cfg, b, cache_len=128, last_only=True)
    assert oc.cost.flops == fc.get_total_flops() == 184811520
    assert oc.kernels == {}
    # the card's prefill runs B2 where the CPU runs the plain mha
    with counting("cuda") as oc:
        M.prefill(p, cfg, b, cache_len=128, last_only=True)
    assert oc.kernels["flash_attention"]["calls"] == cfg.n_layers


def test_bytes_rule():
    """2 x each op's output; views and allocations 0; an in-place scatter
    its source; storages counted once, rounded to 512 bytes, freed when
    they die."""
    x = torch.empty(64, 32, device="meta")
    with counting("cpu") as oc:
        y = x.t()                      # a view: nothing
        z = torch.empty(10, device="meta")   # an allocation: no traffic
        w = x * 2                      # 2 x 8192 bytes
        cache = torch.zeros(1000, 32, device="meta")  # 2 x 128000
        cache.index_copy_(0, torch.empty(4, dtype=torch.long,
                                         device="meta"),
                          torch.empty(4, 32, device="meta"))
    assert oc.by_op.get("t", [0, 0, 0])[2] == 0
    assert oc.by_op["empty"][2] == 0
    assert oc.by_op["mul"][2] == 2 * 64 * 32 * 4
    assert oc.by_op["zeros"][2] == 2 * 1000 * 32 * 4
    assert oc.by_op["index_copy_"][2] == 2 * 4 * 32 * 4
    live = oc.live
    del w, y
    assert oc.live == live - 64 * 32 * 4
    assert oc.peak >= live and z.numel() == 10
    assert op_cost.tensor_bytes({"a": x, "b": [x.t(), z]}) == \
        64 * 32 * 4 + 512


# -- the kernels on meta tensors --------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls():
    q, k = _meta(1, 64, 4, 32), _meta(1, 64, 2, 32)
    dq, dk = _meta(2, 1, 4, 32), _meta(2, 40, 2, 32)
    x = _meta(8, 3, 50, dtype=torch.float32)
    return {
        "flash_attention": (lambda: FA.flash_attention(q, k, k),
                            [(1, 64, 4, 32)]),
        "decode_attention": (lambda: DA.decode_attention(dq, dk, dk,
                                                         kv_len=17),
                             [(2, 1, 4, 32)]),
        "aggregate": (lambda: VR.aggregate(x, "vrmom", K=10), [(3, 50)]),
        "aggregate_sample": (lambda: VR.aggregate_sample(x, "vrmom", K=10,
                                                         top_k=5),
                             [(3, 50), (3, 5), (3, 5)]),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "aggregate", "aggregate_sample"])
def test_wrapper_on_meta(name):
    fn, shapes = _calls()[name]
    with pytest.raises(ValueError, match="meta"):
        fn()
    before = getattr(VR if "agg" in name else
                     (FA if name == "flash_attention" else DA),
                     name).launches
    with counting("cuda") as oc:
        out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "meta" for o in outs)
    assert oc.kernels[name]["calls"] == 1
    # the launch counter counts launches on the card only
    assert getattr(VR if "agg" in name else
                   (FA if name == "flash_attention" else DA),
                   name).launches == before
    with counting("cpu") as oc:       # the plain version on meta tensors
        out = fn()
    assert oc.kernels == {}
    assert [tuple(o.shape) for o in (out if isinstance(out, tuple)
                                     else (out,))] == shapes


def test_meta_branch_keeps_the_cards_checks():
    with counting("cuda"):
        with pytest.raises(ValueError, match="head dim"):
            FA.flash_attention(_meta(1, 8, 2, 48), _meta(1, 8, 2, 48),
                               _meta(1, 8, 2, 48))
        with pytest.raises(TypeError):
            FA.flash_attention(_meta(1, 8, 2, 32, dtype=torch.float16),
                               *[_meta(1, 8, 2, 32, dtype=torch.float16)] * 2)
        with pytest.raises(ValueError, match="group"):
            DA.decode_attention(_meta(1, 1, 34, 32), _meta(1, 8, 2, 32),
                                _meta(1, 8, 2, 32))
        with pytest.raises(ValueError, match="m="):
            VR.aggregate(_meta(200, 4, dtype=torch.float32))
    assert build.counting_target() is None


def _bound_us(cost):
    flops, nbytes = cost
    return max(flops / H100_FLOPS, nbytes / H100_BYTES) * 1e6


def test_costs_give_perf_md_bounds():
    """PERF.md §6's bounds, reckoned by hand before, from ``cost``."""
    assert round(_bound_us(FA.cost((1, 4096, 16, 128), (1, 4096, 8, 128),
                                   torch.bfloat16, causal=True)), 1) == 69.5
    assert round(_bound_us(DA.cost((4, 1, 16, 128), (4, 216, 8, 128),
                                   torch.bfloat16, torch.bfloat16)),
                 2) == 1.07
    assert round(_bound_us(VR.aggregate_cost((8, 4, 151936))), 2) == 6.53
    assert round(_bound_us(VR.aggregate_cost((8, 352321536),
                                             torch.bfloat16))) == 1893
    # a length known on the host reads only its rows; int8 adds the scales
    full = DA.cost((4, 1, 16, 128), (4, 216, 8, 128), torch.bfloat16,
                   torch.int8, quantized=True)
    part = DA.cost((4, 1, 16, 128), (4, 216, 8, 128), torch.bfloat16,
                   torch.int8, kv_len=100, quantized=True)
    assert full[1] - part[1] == 2 * 4 * 116 * (8 * 128 + 4)
    assert FA.cost((2, 10, 4, 32), (2, 30, 2, 32), causal=True)[0] == \
        4 * 2 * 4 * 10 * 30 * 32      # S != T: every pair
    assert VR.aggregate_sample_cost((8, 4, 100), torch.float32, 0, False) \
        == (0, 8 * 4 * 100 * 4 + 4 * 8)


def test_kernel_costs_recorded_on_a_model():
    cfg = tget("qwen3-1.7b")
    p = M.init(cfg, torch.Generator(), device="meta")
    b = {"tokens": torch.empty((4, 192), dtype=torch.int32, device="meta")}
    with counting("cuda") as oc:
        _, caches = M.prefill(p, cfg, b, cache_len=216, last_only=True)
    rec = oc.kernels["flash_attention"]
    one = FA.cost((4, 192, 16, 128), (4, 192, 8, 128), torch.bfloat16)
    assert rec == dict(calls=28, flops=28 * one[0], bytes=28 * one[1])
    tok = torch.zeros((4,), dtype=torch.int32, device="meta")
    with counting("cuda") as oc:
        M.decode_step(p, cfg, caches, tok)
    one = DA.cost((4, 1, 16, 128), (4, 216, 8, 128), torch.bfloat16)
    assert oc.kernels["decode_attention"] == dict(
        calls=28, flops=28 * one[0], bytes=28 * one[1])


# -- dryrun, report, sweep --------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_decode_32k(arch, capsys):
    res = dryrun.dryrun_one(arch, "decode_32k")
    out = capsys.readouterr().out
    assert "roofline" in out and "bottleneck=" in out
    cfg = tget(arch)
    assert res["mesh"] == "1xH100" and res["chips"] == 1
    assert res["collective_bytes_per_chip"] == 0 and res["collectives"] == {}
    assert res["flops_per_chip"] > 0 and res["hbm_bytes_per_chip"] > 0
    assert res["compute_s"] == res["flops_per_chip"] / H100_FLOPS
    assert res["memory_s"] == res["hbm_bytes_per_chip"] / H100_BYTES
    assert res["bottleneck"] in ("compute", "memory")
    assert res["peak_memory_bytes"] == (res["argument_bytes"]
                                        + res["temp_bytes"]
                                        + res["output_bytes"])
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(
        cfg.hybrid_attn_every, 1), "encdec": 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    assert res["kernels"] == ({"decode_attention": n_attn} if n_attn else {})
    assert math.isclose(res["useful_flops_ratio"],
                        res["model_flops_per_chip"] / res["flops_per_chip"])


def test_dryrun_main_writes_json_and_metrics(tmp_path):
    js, ml = tmp_path / "r.json", tmp_path / "m.jsonl"
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                 "--json", str(js), "--metrics-jsonl", str(ml)])
    res = json.loads(js.read_text())
    rec = json.loads(ml.read_text().splitlines()[0])
    assert rec["kind"] == "dryrun" and rec["result"] == res
    assert rec["gauges"]["launch.compile_flops"] == res["flops_per_chip"]
    assert rec["gauges"]["launch.compile_peak_memory_bytes"] == \
        res["peak_memory_bytes"]
    from repro_torch.obs.catalog import METRICS

    names = {m.name for m in METRICS}
    assert set(rec["gauges"]) <= names
    table = report.roofline_table(report.load_jsonl(str(ml)))
    row = [ln for ln in table.splitlines()
           if "mamba2-2.7b | decode_32k" in ln]
    assert len(row) == 1 and "MISSING" not in row[0]
    assert row[0].endswith("| yes |") or row[0].endswith("| NO |")
    assert table.count("MISSING") == 39


def _fake(arch, shape, peak=1e9):
    return {"arch": arch, "shape": shape, "mesh": dryrun.MESH, "mode": "",
            "variant": "", "compute_s": 2e-3, "memory_s": 5e-6,
            "collective_s": 0.0, "bottleneck": "compute",
            "useful_flops_ratio": 0.5, "peak_memory_bytes": peak}


def test_report_from_json_dir(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps(_fake("qwen3-1.7b",
                                                      "train_4k", 90e9)))
    (tmp_path / "b.json").write_text("not json")
    res = report.load(str(tmp_path))
    assert list(res) == [("qwen3-1.7b", "train_4k", "1xH100")]
    table = report.roofline_table(res, md=False)
    assert "fits80G" in table.splitlines()[0]
    line = [ln for ln in table.splitlines() if "qwen3-1.7b" in ln
            and "train_4k" in ln][0]
    assert "2.00ms" in line and "5.00us" in line and "NO" in line
    report.main(["--dir", str(tmp_path), "--md"])
    assert "| qwen3-1.7b | train_4k |" in capsys.readouterr().out


def test_sweep_resumes_and_keeps_errors(tmp_path, capsys):
    ran = []

    def run(arch, shape):
        ran.append((arch, shape))
        if arch == "llama3-405b":
            raise RuntimeError("too big")
        return _fake(arch, shape)

    status, path = sweep.run_one("qwen3-1.7b", "decode_32k", str(tmp_path),
                                 run)
    assert status.startswith("ok(") and json.loads(
        open(path).read())["arch"] == "qwen3-1.7b"
    assert sweep.run_one("qwen3-1.7b", "decode_32k", str(tmp_path),
                         run)[0] == "cached"
    status, path = sweep.run_one("llama3-405b", "train_4k", str(tmp_path),
                                 run)
    assert status == "failed"
    assert "RuntimeError: too big" in open(path + ".err").read()
    assert ran == [("qwen3-1.7b", "decode_32k"), ("llama3-405b", "train_4k")]
    assert len(list(sweep.combos())) == 40
