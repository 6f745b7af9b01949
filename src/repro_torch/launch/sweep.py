"""Run the whole (arch x shape) dry-run sweep on one card's count,
resumable through per-combo JSON files (``repro.launch.sweep``'s
counterpart).

  PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun_torch

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


def run_one(arch, shape, out_dir, run=None):
    """-> (status, path). ``run(arch, shape)`` makes the result
    (``dryrun.dryrun_one`` by default)."""
    path = os.path.join(out_dir, f"{arch}__{shape}__{dryrun.MESH}.json")
    if os.path.exists(path):
        return "cached", path
    run = run or (lambda a, s: dryrun.dryrun_one(a, s, verbose=False))
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
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    todo = list(combos())
    for i, (arch, shape) in enumerate(todo):
        status, _ = run_one(arch, shape, args.out)
        print(f"[{i + 1}/{len(todo)}] {arch} x {shape} x {dryrun.MESH}: "
              f"{status}", flush=True)


if __name__ == "__main__":
    main()
