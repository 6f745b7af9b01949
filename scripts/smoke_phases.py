#!/usr/bin/env python3
"""Run some phases of one checkout's ``chip_smoke.py`` on one GPU.

    python3 scripts/smoke_phases.py --root path/to/checkout --tag NAME \\
        --phases 7,13,14,15

Imports ``chip_smoke.py`` (and with it ``repro_torch``) from ``--root``,
so a parent commit unpacked beside the repository (``git archive``) runs
in the same call as the working tree: run parent, change, change, parent,
each in its own process. Builds that checkout's kernels (phase 1), then
runs each phase named, in the order given, with the smoke's own gates
and printouts; a failed gate exits 1. Phases 3 to 18 can be named (those
that take the card and its name); a phase the checkout lacks is an error.
Prints, last, one JSON line: the tag, the card and each phase's seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

PHASES = {3: "phase_serve", 4: "phase_paper", 5: "phase_configs",
          6: "phase_pool", 7: "phase_train", 8: "phase_adaptive",
          9: "phase_consensus", 10: "phase_moe", 11: "phase_ssm",
          12: "phase_encdec", 13: "phase_train_encdec",
          14: "phase_train_moe", 15: "phase_train_ssm", 16: "phase_lint",
          17: "phase_launch", 18: "phase_wire"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--phases", required=True,
                    help="comma-separated phase numbers, 3 to 18")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("smoke_phases.py: no CUDA device", file=sys.stderr)
        return 2
    phases = [int(p) for p in args.phases.split(",")]
    fns = []
    for p in phases:
        fn = getattr(C, PHASES.get(p, ""), None)
        if fn is None:
            print(f"smoke_phases.py: {root} has no phase {p}",
                  file=sys.stderr)
            return 2
        fns.append(fn)
    card = C.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    secs = {}
    try:
        t = time.perf_counter()
        C.phase_build()
        secs["1"] = time.perf_counter() - t
        for p, fn in zip(phases, fns):
            t = time.perf_counter()
            fn(torch, dev, card)
            secs[str(p)] = time.perf_counter() - t
            print(f"[time] phase {p} {secs[str(p)]:.1f} s")
    except (C.CheckFailed, AssertionError) as exc:
        print(f"smoke_phases.py: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"tag": args.tag, "root": str(root), "card": card,
                      "seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
