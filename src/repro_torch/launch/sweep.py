"""Run the whole dry-run sweep, resumable through per-combo JSON files
(``repro.launch.sweep``'s counterpart): every (arch x shape) on one card's
count, and every arch's train shapes on a rank of ``repro``'s single-pod
and (without ``--single-pod-only``) multi-pod mesh (``dryrun``'s
``--mesh``).

  PYTHONPATH=src python -m repro_torch.launch.sweep \\
      --out results/dryrun_torch [--single-pod-only]

``repro`` runs a subprocess per combo because JAX locks its device count
per process; torch locks none, so the combos run in this one process, and
a combo that raises leaves its traceback in ``<combo>.json.err`` (as
``repro``'s failed subprocess does) while the sweep goes on. A combo whose
JSON exists is skipped.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from ..configs import INPUT_SHAPES
from ..obs.metrics import now
from . import dryrun

ARCHS = ["qwen3-1.7b", "mamba2-2.7b", "granite-moe-3b-a800m", "minitron-4b",
         "phi-3-vision-4.2b", "whisper-medium", "starcoder2-7b",
         "mixtral-8x7b", "zamba2-7b", "llama3-405b"]
SHAPES = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


def combos():
    for shape in SHAPES:
        for arch in ARCHS:
            yield arch, shape


def mesh_combos(include_multipod: bool = True):
    """(arch, train shape, mesh CLI name) of the counts over ranks."""
    for mesh in (["16x16", "2x16x16"] if include_multipod else ["16x16"]):
        for shape in SHAPES:
            if INPUT_SHAPES[shape].kind == "train":
                for arch in ARCHS:
                    yield arch, shape, mesh


def run_one(arch, shape, out_dir, run=None, mesh=None):
    """-> (status, path). ``run(arch, shape)`` makes the result
    (``dryrun.dryrun_one`` by default, over ``mesh``'s ranks when it is
    one of ``dryrun.MESHES``' names)."""
    name = dryrun.MESH if mesh is None else dryrun.mesh_name(
        dryrun.MESHES[mesh])
    path = os.path.join(out_dir, f"{arch}__{shape}__{name}.json")
    if os.path.exists(path):
        return "cached", path
    run = run or (lambda a, s: dryrun.dryrun_one(
        a, s, verbose=False,
        mesh=None if mesh is None else dryrun.MESHES[mesh]))
    t0 = now()
    try:
        res = run(arch, shape)
    except Exception:  # noqa: BLE001 (kept in the .err file)
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc()[-6000:])
        return "failed", path
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return f"ok({now() - t0:.1f}s)", path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--single-pod-only", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    todo = [c + (None,) for c in combos()] + list(
        mesh_combos(include_multipod=not args.single_pod_only))
    for i, (arch, shape, mesh) in enumerate(todo):
        status, _ = run_one(arch, shape, args.out, mesh=mesh)
        print(f"[{i + 1}/{len(todo)}] {arch} x {shape} x "
              f"{mesh or dryrun.MESH}: {status}", flush=True)


if __name__ == "__main__":
    main()
