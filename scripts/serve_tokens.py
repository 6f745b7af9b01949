#!/usr/bin/env python3
"""Print the greedy tokens that one checkout serves on one GPU.

    python3 scripts/serve_tokens.py --src path/to/checkout/src

Imports ``repro_torch`` from ``--src``, so a parent commit unpacked
beside the repository (``git archive``) and the working tree can be run
in one call and their lines compared. Serves ``chip_smoke.py`` phase 3's
workload with its seeds: full-width qwen3-1.7b with seeded random
weights, 4 prompts of 192 tokens, 24 new tokens, robust m = 8 VRMOM
K = 8, alpha = 0.25 under the signflip attack, greedy, shared and
replicated replica compute. Prints one JSON line with the tokens of each
layout and the card's name and power limit; two checkouts serve the same
tokens when their ``tokens`` agree.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N_PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 192, 24


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_tokens.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get as get_arch
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = get_arch("qwen3-1.7b")
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    tokens = torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    out = {"src": args.src, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "tokens": {}}
    for layout, share in (("shared", True), ("replicated", False)):
        robust = RobustDecodeConfig(m=8, estimator="vrmom", K=8, alpha=0.25,
                                    attack="signflip",
                                    share_replica_compute=share)
        eng = ServeEngine(cfg, params, max_len=PROMPT_LEN + NEW_TOKENS,
                          robust=robust, device=dev)
        out["tokens"][layout] = eng.generate({"tokens": tokens},
                                             NEW_TOKENS).tolist()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
