#!/usr/bin/env python3
"""How often ``repro_torch.device.kernels_in_calls`` fails to split its
trace: repeat it on the one-kernel calls that ``chip_smoke.py`` checks.

    python3 scripts/kernels_in_calls_repeat.py --src path/to/src --reps 1000

Imports ``repro_torch`` from ``--src``, so the helper of a parent commit
unpacked beside the repository (``git archive``) can be set against this
one in the same call. Each repeat traces B4 greedy, B4 top-50, B3 with a
python-int length and B1 at the serving shapes, and fails when the trace
does not split into one group a call or a call ran other than one kernel.
Prints one JSON line: the repeats, the failures and the first messages.
"""
from __future__ import annotations

import argparse
import json
import sys
import warnings
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernels_in_calls_repeat.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.device import kernels_in_calls
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.vrmom import aggregate, aggregate_sample

    warnings.filterwarnings("ignore", module="torch.profiler")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = 4.0 * torch.randn((8, 4, 151936), generator=g, device=dev)
    q = torch.randn((4, 1, 16, 128), generator=g, device=dev).to(
        torch.bfloat16)
    k = torch.randn((4, 216, 8, 128), generator=g, device=dev).to(
        torch.bfloat16)
    fns = [lambda: aggregate_sample(x, "vrmom", K=8, with_agg=False),
           lambda: aggregate_sample(x, "vrmom", K=8, top_k=50,
                                    with_agg=False),
           lambda: decode_attention(q, k, k, kv_len=200),
           lambda: aggregate(x, "vrmom", K=8)]
    fails, msgs = 0, []
    for _ in range(args.reps):
        try:
            per = kernels_in_calls(fns)
            assert all(len(n) == 1 for n in per), per
        except (AssertionError, RuntimeError, ValueError) as e:
            fails += 1
            if len(msgs) < 3:
                msgs.append(str(e)[:300])
    print(json.dumps({"tag": args.tag, "src": args.src, "reps": args.reps,
                      "failures": fails, "first": msgs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
