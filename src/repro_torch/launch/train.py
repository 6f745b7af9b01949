"""Training launcher (``repro.launch.train``'s port): robust training of
one model on one card, its workers emulated there, or over the ranks of
a torchrun group (below).

  python -m repro_torch.launch.train --arch qwen3-1.7b --steps 20 \\
      --workers 8 --aggregator vrmom --byzantine 0.25 --attack signflip

runs on the card; ``--reduced --device cpu`` runs the smoke-scale model
on the host. ``--mode`` is ``stacked-rrs`` (the default; on one card the
same as ``stacked-auto``), ``stacked-auto``, ``mean`` or ``inloop``.
``--metrics PATH`` records ``train.step_s``, ``train.loss`` and the
``agg.*`` gauges (a stacked mode: the step returns its
``AggDiagnostics``) into a ``MetricsRegistry`` and appends one snapshot a
step to PATH as a JSON line. ``--checkpoint DIR`` saves params and
optimizer state in ``repro``'s format at the end.

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank joins the default
process group from the environment over ``gloo``, on the CPU and on the
card alike (on the card ``LOCAL_RANK`` picks; gloo takes CUDA tensors and
lets several ranks share one card, and NCCL waits for a host with a card
a rank to be run; ROADMAP §C) and the ranks hold the workers, ``--workers /
WORLD_SIZE`` each: ``stacked-rrs`` and ``inloop`` aggregate over the
multi-rank wire (``make_train_step(group=...)``), and every rank logs the
loss with its rank. Rank 0 alone writes the metrics and the checkpoint.
With ``--byzantine`` the attack must be coordinate-wise
(``core.attacks.COORDINATEWISE``; not the default ``gaussian``).

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen3-1.7b --reduced --steps 2 \
      --device cpu
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import optim as O
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs import get as get_arch
from repro_torch.core.estimator import Estimator
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.metrics import MetricsRegistry, now
from repro_torch.obs.sinks import JsonlSink
from repro_torch.train.step import MODES, make_train_step


def record_step(reg: MetricsRegistry, step_s: float, loss: float,
                diag) -> None:
    """One step's telemetry (``examples/train_byzantine.py``'s set)."""
    reg.observe("train.step_s", step_s)
    reg.gauge("train.loss", loss)
    reg.gauge("agg.alpha_hat", float(diag.alpha_hat))
    reg.gauge("agg.suspected_workers", float(diag.suspected.sum()))
    reg.gauge("agg.grad_norm_pre", float(diag.pre_norms.mean()))
    reg.gauge("agg.grad_norm_post", float(diag.post_norm))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--aggregator", default="vrmom",
                    choices=["vrmom", "mom", "trimmed_mean", "mean"])
    ap.add_argument("--mode", default="stacked-rrs", choices=MODES)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--beta", type=float, default=None,
                    help="trimmed_mean trim fraction per end (default: "
                         "0.1, raised to 1/workers when 0.1 trims no rows)")
    ap.add_argument("--byzantine", type=float, default=0.0)
    ap.add_argument("--attack", default="gaussian")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--metrics", default=None,
                    help="write per-step telemetry to this JSONL file")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    group, rank, tag = _join_group()
    if group is not None and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    beta = args.beta if args.beta is not None else max(0.1,
                                                       1.0 / args.workers)
    # every rank takes the same path (the diagnostics' all_reduce); rank 0
    # alone writes the files
    with_diag = args.metrics is not None and args.mode != "inloop"
    if rank:
        args.metrics = args.checkpoint = None
    optimizer = O.get(cfg.optimizer, lr=args.lr)
    setup = make_train_step(
        cfg, args.workers,
        estimator=Estimator(method=args.aggregator, K=args.K, beta=beta),
        mode=args.mode, optimizer=optimizer, byzantine_frac=args.byzantine,
        attack=args.attack, with_diag=with_diag, device=device, group=group)

    params = M.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    opt_state = optimizer.init(params)
    reg = MetricsRegistry() if args.metrics else None
    sink = JsonlSink(args.metrics) if args.metrics else None

    n_params = M.param_count(params)
    print(f"{tag}arch={cfg.name} params={n_params/1e6:.1f}M device={device} "
          f"workers={setup.n_workers} aggregator={args.aggregator} "
          f"mode={args.mode} byzantine={args.byzantine} attack={args.attack}")

    t0 = now()
    for i in range(args.steps):
        batch = lm_batch(cfg, i, args.batch, args.seq, device=device)
        gen = torch.Generator(device=device).manual_seed(i)
        ts = now()
        out = setup.step_fn(params, opt_state, batch, gen)
        params, opt_state, loss = out[:3]
        loss = float(loss)  # waits for the step's device work
        if reg is not None:
            if with_diag:
                record_step(reg, now() - ts, loss, out[3])
            else:
                reg.observe("train.step_s", now() - ts)
                reg.gauge("train.loss", loss)
            sink.write_registry(reg, step=i)
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = now() - t0
            print(f"{tag}step {i:4d} loss {loss:.4f} ({dt/(i+1):.2f} "
                  f"s/step)")
    if sink is not None:
        sink.close()
        print("metrics written to", args.metrics)
    if args.checkpoint:
        ckpt_save(args.checkpoint, {"params": params, "opt": opt_state})
        print("checkpoint saved to", args.checkpoint)
    if group is not None:
        torch.distributed.destroy_process_group()


def _join_group():
    """(group, rank, log prefix): the default process group joined over
    gloo from torchrun's environment when ``WORLD_SIZE`` > 1, else (None,
    0, "")."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None, 0, ""
    import torch.distributed as dist

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    return dist.group.WORLD, rank, f"[rank {rank}/{world}] "


if __name__ == "__main__":
    main()
