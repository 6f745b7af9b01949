#!/usr/bin/env python3
"""Instruction counts of a built kernel's SASS, and the time to issue them.

    python3 scripts/sass_issue.py LIB.so KERNEL [KERNEL ...] \
        [--skip LO-HI,...] [--trips 4,8] [--per N] [--threads T]

Runs ``cuobjdump -sass`` on a library that ``repro_torch.kernels.build``
made (or reads a saved dump, a ``.txt`` file), and for each function
whose mangled name contains every ``KERNEL`` substring given prints
its static instruction count, the opcodes it uses most and each loop
(a backward branch): its first and last address and its size in
instructions. Nested loops are listed each on its own.

``--skip LO-HI,...`` leaves out address ranges (hex) that the path
being counted does not run: another method's code, or a loop's
remainder that a trip count divisible by its unrolling never enters.
``--trips`` gives a trip count to each listed loop in address order
(missing ones count once), so the script can add up the instructions
one thread executes: the straight-line code once, each loop's body
(the instructions between its head and its backward branch, minus those
of the loops nested in it) as often as the product of the trip counts of
the loops around and including it. ``--per N`` divides that by the N
coordinates a thread handles. ``--threads T`` is how many threads run it:
then the issue time is T x (instructions a thread) / 32 warp
instructions over the H100's issue rate, 132 SMs x 4 schedulers x one
warp instruction a cycle at 1.98 GHz (its boost clock). That is the
least time THIS build's instructions take, not a bound on the function:
another build may need fewer.

NOPs and the padding after the last EXIT are not counted.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ISSUE_PER_S = 132 * 4 * 1.98e9  # warp instructions a second
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TARGET = re.compile(r"(?:0x([0-9a-f]+)|`\(\.L_x_(\d+)\))")
LABEL = re.compile(r"^\s*\.L_x_(\d+):")


def cuobjdump() -> str:
    for cand in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump")):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit("sass_issue.py: cuobjdump not found (CUDA toolkit)")


def functions(text: str) -> dict:
    """mangled name -> [(address, instruction text)], with labels resolved
    to addresses in the branch targets."""
    out, cur, labels = {}, None, {}
    pending = []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            labels = {}
            out[cur + "\0labels"] = labels
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            out[cur].append((addr, m.group(2)))
    return out


def analyse(insns: list, labels: dict):
    # drop the padding after the last EXIT / BRA-to-self
    last = max((i for i, (_, t) in enumerate(insns) if "EXIT" in t),
               default=len(insns) - 1)
    body = [(a, t) for a, t in insns[:last + 1]
            if not t.split()[0].startswith("NOP")]
    loops = []
    for a, t in body:
        op = t.split()
        if not any(w.startswith("BRA") for w in op):
            continue
        m = TARGET.search(t)
        if m is None:
            continue
        tgt = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2))
        if tgt is not None and tgt <= a:
            loops.append((tgt, a))
    loops.sort()
    return body, loops


def executed(body, loops, trips) -> float:
    total = 0.0
    for a, _ in body:
        mult = 1.0
        for j, (lo, hi) in enumerate(loops):
            if lo <= a <= hi:
                mult *= trips[j] if j < len(trips) else 1
        total += mult
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("lib")
    ap.add_argument("kernel", nargs="+")
    ap.add_argument("--trips", default="")
    ap.add_argument("--skip", default="")
    ap.add_argument("--per", type=float, default=1.0)
    ap.add_argument("--threads", type=float, default=0.0)
    args = ap.parse_args()
    if args.lib.endswith(".txt"):
        text = Path(args.lib).read_text()
    else:
        text = subprocess.run([cuobjdump(), "-sass", args.lib],
                              capture_output=True, text=True,
                              check=True).stdout
    trips = [float(t) for t in args.trips.split(",") if t]
    funcs = functions(text)
    found = False
    for name, insns in funcs.items():
        if "\0" in name or not all(k in name for k in args.kernel):
            continue
        found = True
        body, loops = analyse(insns, funcs[name + "\0labels"])
        for rng in filter(None, args.skip.split(",")):
            lo, hi = (int(h, 16) for h in rng.split("-"))
            body = [(a, t) for a, t in body if not lo <= a <= hi]
        ops = Counter(t.split()[0].lstrip("@!P0123456789T ").split(".")[0]
                      if not t.startswith("@") else t.split()[1].split(".")[0]
                      for _, t in body)
        print(f"{name}: {len(body)} instructions")
        print("  opcodes: " + ", ".join(f"{k} {v}"
                                        for k, v in ops.most_common(14)))
        for j, (lo, hi) in enumerate(loops):
            n = sum(1 for a, _ in body if lo <= a <= hi)
            print(f"  loop {j}: {lo:#06x}-{hi:#06x}, {n} instructions, "
                  f"trips {trips[j] if j < len(trips) else 1:g}")
        per_thread = executed(body, loops, trips)
        per_coord = per_thread / args.per
        print(f"  executed a thread: {per_thread:g}; a coordinate: "
              f"{per_coord:g}")
        if args.threads:
            us = args.threads * per_thread / 32 / ISSUE_PER_S * 1e6
            print(f"  issue time for {args.threads:g} threads at the peak "
                  f"rate: {us:.3f} us")
    if not found:
        print(f"sass_issue.py: no function matches {args.kernel}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
