#!/usr/bin/env python3
"""How far each attack moves the robust aggregate of one training step's
gradient, at several sizes of a worker's batch, on one GPU.

    python3 scripts/train_robustness.py [--sizes 1x4096,8x4096] [--trials]

Takes ``chip_smoke.py`` phase 7's model and steps: full-width qwen3-1.7b
from seeded weights, W = 8 workers, VRMOM K 10, one clean AdamW step and
three under signflip. Then, for each size ``NxS`` (N sequences of S
tokens a worker, accumulated in microbatches of one sequence), it takes
the stacked per-worker gradient of ``data.lm_batch`` step 5 and prints
JSON lines from ``chip_smoke.robust_shift`` with 2 of 8 rows attacked
(alpha 0.3), for the whole gradient and then each leaf: each
aggregator's cosine with its clean aggregate and its shift over the
rows' RMS distance, beside the zero aggregate's ratio and each clean
row's cosine with VRMOM's aggregate. With ``--trials`` it also prints
``step_trials``: the held-out loss drop of one AdamW step from a fresh
state on each aggregate. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def step_trials(torch, cfg, params, stack, est, gen, mask, held,
                lr: float) -> dict:
    """Held-out loss drops of one step: from ``params``, one AdamW step
    from a fresh state (a sign step of size ``lr``) on each aggregate of
    the clean ``stack`` (zeros, VRMOM and the mean, clean and under each
    of ``chip_smoke.ROBUST_ATTACKS`` on the rows of ``mask``), and the
    mean loss over the rows of ``held`` before minus after, keyed
    (aggregator, attack or None). ``params`` are restored after each trial."""
    from chip_smoke import ROBUST_ATTACKS
    from repro_torch import optim as O
    from repro_torch.core import attacks as TA
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.models import model as M
    from repro_torch.tree import leaves, unflatten

    W = int(mask.numel())
    opt = O.get("adamw", lr=lr)

    def held_loss():
        n = held["tokens"].shape[0]
        with torch.no_grad():
            return sum(float(M.loss(params, cfg, {k: v[i:i + 1] for k, v
                                                  in held.items()}))
                       for i in range(n)) / n

    def aggregated(name, attack):
        out = []
        for leaf in leaves(stack):
            flat = leaf.reshape(W, -1)
            o = torch.empty(flat.shape[1:], dtype=leaf.dtype,
                            device=leaf.device)
            for c0 in range(0, flat.shape[1], 1 << 26):
                x = flat[:, c0:c0 + (1 << 26)].contiguous()
                if name == "zero":
                    o[c0:c0 + x.shape[1]] = 0
                    continue
                if attack is not None:
                    x = TA.get(attack)(gen, x, mask)
                o[c0:c0 + x.shape[1]] = RR.aggregate(
                    x, mode="mean" if name == "mean" else "stacked-auto",
                    est=est)
            out.append(o.reshape(leaf.shape[1:]))
        return unflatten(params, out)

    before = held_loss()
    saved = [t.clone() for t in leaves(params)]
    drops = {}
    for key in [("zero", None), ("vrmom", None), ("mean", None)] + [
            (name, atk) for name in ("vrmom", "mean")
            for atk in ROBUST_ATTACKS]:
        g = aggregated(*key)
        opt.update(g, opt.init(params), params)
        del g
        drops[key] = before - held_loss()
        for t, sv in zip(leaves(params), saved):
            t.copy_(sv)
    del saved
    return {"before": before, "drops": drops}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1x4096,8x4096",
                    help="comma-separated NxS: N sequences of S tokens a "
                         "worker")
    ap.add_argument("--trials", action="store_true",
                    help="also print step_trials' held-out loss drops at "
                         "each size (held out: lm_batch step 6, 8 x 4096)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_robustness.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch import optim as O
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step, stacked_grads

    card = CS.card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-1.7b")
    W, S = CS.TRAIN_W, CS.TRAIN_SEQ
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    est = Estimator("vrmom", K=CS.TRAIN_K)
    opt = O.get("adamw", lr=CS.TRAIN_LR)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i, alpha in enumerate((0.0,) + (CS.TRAIN_ALPHA,) * 3):
        step = make_train_step(cfg, W, estimator=est, mode="stacked-auto",
                               optimizer=opt, byzantine_frac=alpha,
                               attack="signflip", device=dev)
        step.step_fn(params, opt_state, lm_batch(cfg, i, W, S, device=dev),
                     gen)
    del opt_state
    torch.cuda.empty_cache()
    mask = torch.arange(W, device=dev) >= W - int(CS.TRAIN_ROBUST_ALPHA
                                                  * (W - 1))
    for size in args.sizes.split(","):
        n, seq = (int(v) for v in size.split("x"))
        t0 = time.perf_counter()
        _, stack = stacked_grads(cfg, params,
                                 lm_batch(cfg, 5, W * n, seq, device=dev),
                                 W, microbatch=n)
        torch.cuda.synchronize()
        t_grads = time.perf_counter() - t0
        r = CS.robust_shift(torch, stack, est, gen, mask)
        if args.trials:
            tr = step_trials(torch, cfg, params, stack, est, gen, mask,
                                lm_batch(cfg, 6, W, S, device=dev),
                                CS.TRAIN_LR)
            print(json.dumps({"size": size, "held_loss": tr["before"],
                              "drops": {f"{k[0]} {k[1]}": v for k, v in
                                        tr["drops"].items()}}), flush=True)
        del stack
        torch.cuda.empty_cache()
        for where, sr in [("all", r)] + sorted(r["leaf"].items()):
            print(json.dumps({
                "size": size, "leaf": where, "grads_s": round(t_grads, 3),
                "zero": sr["zero"],
                "row_cos": [round(c, 4) for c in sr["row_cos"]],
                **{f"{k[0]} {k[1]}": {"cos": sr["cos"][k],
                                      "ratio": sr["ratio"][k]}
                   for k in sorted(sr["cos"])}}), flush=True)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
