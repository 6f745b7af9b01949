"""One-card dry run: count every (arch x input shape) on the meta device and
turn the count into a roofline (``repro.launch.dryrun``'s counterpart).

``repro`` lowers and compiles each combo for a 16x16 (or 2x16x16) TPU
mesh and reads XLA's memory analysis and its own HLO cost model. The port
runs on one card, so the whole global batch goes to one NVIDIA H100: the
params, the optimizer state and the inputs are meta tensors (nothing is
allocated), the step runs under ``op_cost.counting`` (FLOPs from
``torch.utils.flop_counter``'s formulas and the kernels' own ``cost``,
bytes from the dispatched ops' outputs, the peak from the storages they
hold) and the roofline takes the card's published peaks. One card has no
collectives: ``collective_bytes_per_chip`` is 0.

With a mesh (``mesh=make_production_mesh(...)``, ``--mesh 16x16`` or
``2x16x16``; train shapes only) the count is one rank's of ``repro``'s
worker axes: ``pod`` x ``data`` = P ranks (16 single-pod, 32 multi-pod) of
a fake process group (``op_cost.fake_group``: the collectives take meta
tensors and move nothing), one worker each (``n_workers = P``, as
``repro``'s ``make_train_step`` reckons it; W_loc 1), each rank's batch
share ``global_batch / P``, its step ``make_train_step(..., group=)``: the
RRS wire (``stacked-rrs``) or ``robust_dot`` on it (``inloop``). Every
rank's RRS slice is ``ceil(n / P)`` coordinates, so rank 0, the rank
counted, holds as large a slice as any. ``collectives`` are the count's
``Cost.coll`` (operand bytes by kind, ``hlo_cost``'s rule) and
``collective_s`` prices their sum at one H100's NVLink rate
(``H100_NVLINK_BW``); past 8 ranks the ranks span nodes, whose network is
slower, and that is not reckoned. ``repro``'s meshes also shard every
layer over their ``model`` axis (16 ways); the port shards no layer
(``dist.ctx``'s mesh half is inert), so each rank holds the whole model
and the count has no tensor-parallel collective: the record says so
(``model_axis_sharded``). Prefill and decode over ranks wait for that
work too (ROADMAP A5e): with a mesh they raise. The count joins this
process to the fake group and leaves it: the process must hold no
default process group.

* train: ``make_train_step`` with ``repro``'s W = 16 workers and
  ``cfg.optimizer`` (llama3-405b: adafactor), byzantine 0, counted by
  trip count (``op_cost.trips``): one micro-step of one worker is traced
  and counted W x micro times, each worker's accumulation and stack copy
  W times, the aggregate (B1 on each leaf's ``[W, ...]`` stack) and the
  optimizer once. A train_4k step is 256 sequences of 4096 tokens, one a
  micro-step: traced op by op it would take minutes an arch. The peak is
  the resident state (params, opt state, the stack, the f32 accumulators)
  plus one micro-step's high-water mark, or the aggregate's or the
  optimizer's, whichever is higher.
* prefill: ``model.prefill`` whole, last-position logits, caches of
  ``seq_len``.
* decode: one ``model.decode_step`` over ``init_cache(..., seq_len)``.

``long_500k`` keeps ``repro``'s policy: a full-attention arch runs its
SWA-4096 variant. The stacked-to-inloop switch keeps ``repro``'s rule at
``repro``'s single-pod model axis (``REPRO_TP`` = 16): a stacked mode
becomes inloop where one worker's f32 gradient over 16 model shards
passes 4 GB (llama3-405b and mixtral-8x7b), so every row runs the mode of
``repro``'s matching 16x16 row and the two sweeps read side by side.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k [--mode stacked-rrs] [--mesh 16x16 | 2x16x16] \\
      [--json out.json] [--metrics-jsonl metrics.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from .. import optim as O
from ..configs import INPUT_SHAPES, get as get_arch, input_specs
from ..models import model as M
from ..obs.metrics import now
from ..train.step import make_train_step
from .mesh import MeshShape, make_production_mesh
from .op_cost import counting, fake_group, tensor_bytes

__all__ = ["dryrun_one", "write_metrics_jsonl", "active_params",
           "model_flops", "mesh_name", "main",
           "H100_PEAK_FLOPS", "H100_HBM_BW", "H100_NVLINK_BW", "N_WORKERS",
           "MESH", "MESHES"]

# NVIDIA H100 SXM5 80GB (data sheet): dense bf16 tensor-core peak, HBM3,
# NVLink 4 (900 GB/s both ways together: 450 GB/s each way)
H100_PEAK_FLOPS = 989e12   # FLOP/s
H100_HBM_BW = 3.35e12      # bytes/s
H100_NVLINK_BW = 450e9     # bytes/s out of one card
MESH = "1xH100"
# repro's production meshes by their CLI names
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
N_WORKERS = 16    # repro's single-pod worker count (the 16x16 data axis)
REPRO_TP = 16     # repro's single-pod model axis: the inloop switch's


def active_params(cfg) -> float:
    """``repro``'s analytic active-parameter count: every parameter, less
    the share (1 - top_k / n_experts) of the expert weights, reckoned as
    ``n_layers * 3 * E * d_model * d_ff``."""
    total = M.param_count(M.init(cfg, torch.Generator(), device="meta"))
    if cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        expert = cfg.n_layers * 3 * e * cfg.d_model * cfg.d_ff
        total -= expert * (1 - k / e)
    return float(total)


def model_flops(cfg, shape) -> float:
    """``repro``'s analytic model FLOPs of one step on the whole global
    batch: 6 · N_active · tokens for train (forward and backward), 2 ·
    N_active · tokens for prefill, one token a sequence for decode."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return (6.0 if shape.kind == "train" else 2.0) * active_params(cfg) \
        * tokens


def mesh_name(mesh: MeshShape) -> str:
    """The record's name for what a count over ``mesh`` counts: its worker
    axes' sizes, a card each ("16xH100", "2x16xH100")."""
    return "x".join(str(mesh.shape[a]) for a in ("pod", "data")
                    if a in mesh.shape) + "xH100"


def _fresh_bytes(out, args) -> int:
    """Bytes of the storages in ``out`` that are not storages of ``args``."""
    from torch.utils._pytree import tree_flatten

    arg_st = {id(t.untyped_storage()) for t in tree_flatten(args)[0]
              if isinstance(t, torch.Tensor)}
    fresh = [t for t in tree_flatten(out)[0]
             if isinstance(t, torch.Tensor)
             and id(t.untyped_storage()) not in arg_st]
    return tensor_bytes(fresh)


def _count(cfg, shape, mode: str, window, group=None):
    """(OpCost, argument bytes, output bytes) of one step on meta tensors,
    counted as the card runs it (the kernels where it runs them); a train
    step over ``group`` is one rank's, a worker a rank."""
    params = M.init(cfg, torch.Generator(), device="meta")
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = O.get(cfg.optimizer, lr=1e-3)
        opt_state = opt.init(params)
        n_workers = N_WORKERS if group is None else group.size()
        setup = make_train_step(cfg, n_workers, mode=mode, optimizer=opt,
                                device="meta", group=group)
        args = (params, opt_state, batch)
        with counting("cuda", reckon=True) as oc:
            out = setup.step_fn(*args)
    elif shape.kind == "prefill":
        args = (params, batch)
        with counting("cuda") as oc:
            out = M.prefill(params, cfg, batch, window=window,
                            cache_len=shape.seq_len, last_only=True)
    else:
        caches = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                              window=window, device="meta")
        args = (params, caches, batch)
        with counting("cuda") as oc:
            out = M.decode_step(params, cfg, caches, batch["token"],
                                window=window)
    return oc, tensor_bytes(args), _fresh_bytes(out, args)


def dryrun_one(arch: str, shape_name: str, *, mode: str = "stacked-rrs",
               mesh: MeshShape = None, verbose: bool = True) -> dict:
    """The count and roofline of ``arch`` at ``shape_name`` on one card, in
    ``repro``'s result keys (``mesh`` "1xH100", ``chips`` 1), with the
    kernels' calls and the host seconds the count took; with ``mesh``, of
    one of its worker ranks (module docstring: ``mesh`` named for the
    ranks, ``chips`` their number, the collectives filled)."""
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    if mesh is not None and shape.kind != "train":
        raise ValueError(
            f"{shape_name} over a mesh: the port serves on one card; "
            f"prefill and decode over ranks wait for the model axis to be "
            f"sharded (ROADMAP A5e)")
    window, variant = "cfg", ""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        window, variant = 4096, "swa4096-variant"
    if shape.kind == "train" and mode.startswith("stacked"):
        n_params = active_params(cfg) if cfg.moe is None else float(
            M.param_count(M.init(cfg, torch.Generator(), device="meta")))
        if n_params * 4.0 / REPRO_TP > 4e9:
            mode = "inloop"
    t0 = now()
    if mesh is None:
        chips, name = 1, MESH
        oc, arg_bytes, out_bytes = _count(cfg, shape, mode, window)
    else:
        chips = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
        name = mesh_name(mesh)
        with fake_group(chips) as group:
            oc, arg_bytes, out_bytes = _count(cfg, shape, mode, window,
                                              group)
    host_s = now() - t0
    flops, nbytes = oc.cost.flops, oc.cost.bytes
    coll = dict(oc.cost.coll)
    coll_bytes = float(sum(coll.values()))

    mflops = model_flops(cfg, shape) / chips
    terms = {"compute_s": flops / H100_PEAK_FLOPS,
             "memory_s": nbytes / H100_HBM_BW,
             "collective_s": coll_bytes / H100_NVLINK_BW}
    result = {
        "arch": arch, "shape": shape_name, "mesh": name, "chips": chips,
        "mode": mode if shape.kind == "train" else "", "variant": variant,
        "flops_per_chip": flops, "hbm_bytes_per_chip": nbytes,
        "collective_bytes_per_chip": coll_bytes, "collectives": coll,
        "model_flops_per_chip": mflops,
        "useful_flops_ratio": mflops / max(flops, 1.0),
        **terms,
        "bottleneck": max(terms, key=terms.get).replace("_s", ""),
        "peak_memory_bytes": arg_bytes + oc.peak,
        "temp_bytes": oc.peak - out_bytes,
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "kernels": {k: v["calls"] for k, v in oc.kernels.items()},
        "host_s": host_s,
    }
    if mesh is not None:
        result["model_axis_sharded"] = False
    if verbose:
        print(f"== {arch} x {shape_name} on {name}"
              f"{' (mode=' + mode + ')' if result['mode'] else ''}"
              f"{' ' + variant if variant else ''} ==")
        print("memory: peak={:.3e} B (arguments {:.3e}, temp {:.3e}, "
              "output {:.3e})".format(result["peak_memory_bytes"], arg_bytes,
                                      result["temp_bytes"], out_bytes))
        print("cost: flops={:.3e} bytes={:.3e}; kernels {}".format(
            flops, nbytes, result["kernels"]))
        print("model_flops/chip={:.3e} useful_ratio={:.3f}".format(
            mflops, result["useful_flops_ratio"]))
        if mesh is not None:
            print("collectives (operand bytes a rank; repro's model axis "
                  "not sharded):", {k: f"{v:.3e}" for k, v in coll.items()})
        print("roofline (H100 SXM5, 989 TFLOP/s bf16, 3.35 TB/s, NVLink "
              "450 GB/s): compute={:.3e}s memory={:.3e}s collective={:.3e}s"
              " -> bottleneck={}  [counted in {:.1f} s of host]".format(
                  terms["compute_s"], terms["memory_s"],
                  terms["collective_s"], result["bottleneck"], host_s))
    return result


def write_metrics_jsonl(res: dict, path: str) -> None:
    """Append one ``kind: "dryrun"`` record to a telemetry JSONL: the count
    as ``launch.*`` gauges (``obs.catalog``) beside the whole result, which
    ``launch.report.load_jsonl`` reads."""
    from ..obs.sinks import JsonlSink

    with JsonlSink(path) as sink:
        sink.write({
            "kind": "dryrun",
            "gauges": {
                "launch.compile_flops": res["flops_per_chip"],
                "launch.compile_hbm_bytes": res["hbm_bytes_per_chip"],
                "launch.compile_collective_bytes":
                    res["collective_bytes_per_chip"],
                "launch.compile_peak_memory_bytes": res["peak_memory_bytes"],
            },
            "meta": {"arch": res["arch"], "shape": res["shape"],
                     "mesh": res["mesh"], "mode": res["mode"]},
            "result": res,
        })


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mode", default="stacked-rrs")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="count one rank of this production mesh's worker "
                    "axes (train shapes)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append the count to this telemetry JSONL "
                    "(obs.sinks wire format)")
    args = ap.parse_args(argv)
    res = dryrun_one(args.arch, args.shape, mode=args.mode,
                     mesh=MESHES[args.mesh] if args.mesh else None)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    if args.metrics_jsonl:
        write_metrics_jsonl(res, args.metrics_jsonl)


if __name__ == "__main__":
    main()
