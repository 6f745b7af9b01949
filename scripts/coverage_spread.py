#!/usr/bin/env python3
"""The coverage of one regimes cell over several seeds, in either package.

    python3 scripts/coverage_spread.py --package repro --attack ipm \
        --arm vrmom --seeds 0 1 2 3 [--reps 480]
    python3 scripts/coverage_spread.py --package repro_torch --attack ipm \
        --arm vrmom --seeds 0 1 2 3 [--device cpu]
    python3 scripts/coverage_spread.py --package repro --cell consensus \
        --seeds 0

``--cell consensus`` runs ``tests/test_consensus.py``'s consensus cell
instead (linear, alie at alpha 0.1, vrmom K 5, m 20, n 100, p 3, 4
rounds, ``reduce_backend="consensus"`` with f 2 under 10% message
dropout), the cell ``chip_smoke.py`` phase 9 (c) runs on the card.

Runs ``coverage_run`` at ``BENCH_regimes.json``'s coverage cell (linear,
alpha 0.2, m 100, n 100, p 5, 4 rounds, level 0.95, K 10; the fixed arms
at ``assumed_alpha`` 0, the adaptive arms at the census's alpha_hat of an
attacked [101, 64] stack, as ``benchmarks/regimes.py`` does) once per
seed, and prints one JSON line per seed and one with the mean: how far a
cell's coverage spreads from draw to draw, which the record's single
draw of 96 replications does not say. ``repro`` runs with its ``jnp``
backend on the host's CPUs (``JAX_PLATFORMS=cpu``); the port runs on
``--device`` (the card unless named).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ADAPTIVE = ("vrmom_adaptive", "auto_gm")


def cell_repro(attack, arm, reps, seed, batch):
    import jax

    from repro.core import adaptive as AD, attacks as A
    from repro.core.estimator import Estimator
    from repro.infer.coverage import coverage_run

    assumed = 0.0
    if arm in ADAPTIVE:
        v = jax.random.normal(jax.random.PRNGKey(0), (101, 64)) + 1.0
        mask = A.byzantine_mask(101, 0.2)
        v = A.REGISTRY[attack](jax.random.PRNGKey(1), v, mask)
        assumed = float(AD.estimate_alpha(v, axis=0))
    return coverage_run(
        model="linear", attack=attack, alpha=0.2,
        estimator=Estimator(arm, K=10, backend="jnp"), reps=reps,
        N_per_machine=100, m_workers=100, p=5, rounds=4, level=0.95,
        batch_size=batch, seed=seed, assumed_alpha=assumed).summary()


def cell_port(attack, arm, reps, seed, batch, device):
    import torch

    from repro_torch.core import adaptive as AD, attacks as A
    from repro_torch.core.estimator import Estimator
    from repro_torch.infer import coverage_run

    assumed = 0.0
    if arm in ADAPTIVE:
        g = torch.Generator(device=device).manual_seed(0)
        v = torch.randn((101, 64), generator=g, device=device) + 1.0
        mask = A.byzantine_mask(101, 0.2, device=device)
        assumed = float(AD.estimate_alpha(A.get(attack)(g, v, mask),
                                          backend="auto"))
    return coverage_run(
        model="linear", attack=attack, alpha=0.2,
        estimator=Estimator(arm, K=10), reps=reps, N_per_machine=100,
        m_workers=100, p=5, rounds=4, level=0.95, batch_size=batch,
        seed=seed, device=device, assumed_alpha=assumed).summary()


# tests/test_consensus.py's consensus cell (chip_smoke.py phase 9 c)
CONSENSUS_CELL = dict(model="linear", attack="alie", alpha=0.1, K=5,
                      N_per_machine=100, m_workers=20, p=3, rounds=4,
                      reduce_backend="consensus")


def consensus_repro(reps, seed, batch):
    from repro.dist.consensus import ConsensusConfig
    from repro.dist.faults import FaultPlan
    from repro.infer.coverage import coverage_run

    return coverage_run(estimator="vrmom", reps=reps, batch_size=batch,
                        seed=seed, consensus=ConsensusConfig(f=2),
                        fault_plan=FaultPlan(dropout=0.1),
                        **CONSENSUS_CELL).summary()


def consensus_port(reps, seed, batch, device):
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.infer import coverage_run

    return coverage_run(estimator="vrmom", reps=reps, batch_size=batch,
                        seed=seed, consensus=ConsensusConfig(f=2),
                        fault_plan=FaultPlan(dropout=0.1), device=device,
                        **CONSENSUS_CELL).summary()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    required=True)
    ap.add_argument("--attack", default="ipm")
    ap.add_argument("--arm", default="vrmom")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--reps", type=int, default=480)
    ap.add_argument("--batch", type=int, default=None,
                    help="replications a chunk (repro: 12, as the record; "
                         "the port: 240)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--cell", choices=("regimes", "consensus"),
                    default="regimes")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.cell == "consensus":
        args.attack, args.arm = "alie", "vrmom"
    covs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.cell == "consensus" and args.package == "repro":
            s = consensus_repro(args.reps, seed, args.batch or 12)
        elif args.cell == "consensus":
            s = consensus_port(args.reps, seed, args.batch or 240,
                               args.device)
        elif args.package == "repro":
            s = cell_repro(args.attack, args.arm, args.reps, seed,
                           args.batch or 12)
        else:
            s = cell_port(args.attack, args.arm, args.reps, seed,
                          args.batch or 240, args.device)
        covs.append(s["coverage"])
        print(json.dumps({"package": args.package, "cell": args.cell,
                          "attack": args.attack, "arm": args.arm,
                          "seed": seed, "reps": args.reps,
                          "coverage": s["coverage"],
                          "mean_width": s["mean_width"], "rmse": s["rmse"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"package": args.package, "attack": args.attack,
                      "arm": args.arm, "seeds": args.seeds,
                      "mean_coverage": sum(covs) / len(covs),
                      "min": min(covs), "max": max(covs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
