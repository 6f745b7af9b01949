"""The Byzantine-robust train step (``repro.train.step``'s port).

``make_train_step`` wires the paper's technique into training on one
card, with W workers emulated there: per-worker gradients, the simulated
Byzantine corruption of the last rows, coordinate-wise robust
aggregation (``dist.robust_reduce``), the optimizer update. The worker
count takes the place of ``repro``'s mesh.

* **Stacked modes** (``stacked-rrs``, ``stacked-auto``, ``mean``, and
  ``stacked-adaptive``, which an adaptive estimator selects): the
  global batch is split into W equal worker slices; each worker's
  gradients come from autograd (with ``repro``'s microbatch accumulation
  in f32, cast back) and are copied into a stack ``[W, ...]`` per leaf in
  the param dtype, as ``repro``'s ``worker_grad`` returns them. The
  ``n_byz = int(alpha * (W - 1))`` last rows are attacked in place, leaf
  by leaf, and the stack is aggregated (B1 on the card, reading the bf16
  stack itself). The workers run one after another: a ``vmap`` would have
  to batch the kernels inside the attention's autograd Function. An
  adaptive estimator (``auto_gm``, ``vrmom_adaptive``) aggregates the whole
  stack with ``dist.robust_reduce.aggregate_stacked_adaptive`` and an
  explicit ``AdaptiveState`` carry (``TrainSetup.init_state``).
* **stacked-consensus** (``reduce_backend="consensus"``): the stacked
  wire through the peer-to-peer consensus emulation
  (``dist.consensus``), under a ``ConsensusConfig`` and an optional
  ``FaultPlan``; the attacked rows are pinned (they re-send their payload
  every round) and the dropout is drawn from the step's generator after
  the attack's. The step returns a ``ConsensusAux`` after the loss.
* **inloop**: one global backward under ``robust_backward``; every
  3-D x 2-D product aggregates its weight gradient over the workers in
  the backward (``repro``'s IB-RRS), with ``repro``'s strided micro-split
  so each micro-step holds an equal block of every worker.

The step is eager: it runs on the device of the params, the card unless
the caller names another, and reads no device value on the host (the
loss stays a 0-d tensor). Its worker and micro-step loops run the same
ops on the same shapes every trip (``launch.op_cost.trips``), so a cost
count can count one trip and multiply it (``launch.dryrun``). Spans
``train.worker_grads``, ``train.aggregate`` and ``train.optimizer`` name
its parts in a profiler trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import optim as O
from ..core import attacks as atk
from ..convert import expected_shapes
from ..core.estimator import Estimator
from ..device import resolve_device
from ..dist import robust_reduce as RR
from ..launch.op_cost import trips
from ..models import model as M
from ..obs.trace import named_span
from ..tree import (leaves as _leaves, paths as tree_paths, tree_map,
                    unflatten as _unflatten)

__all__ = ["TrainSetup", "make_train_step", "stacked_grads", "loss_and_grads",
           "MODES"]

MODES = ("stacked-rrs", "stacked-auto", "mean", "inloop")


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    step_fn: Callable
    n_workers: int
    optimizer: O.Optimizer
    device: torch.device
    # adaptive estimators only: a zero-arg callable making the initial
    # core.adaptive.AdaptiveState on the step's device; the step takes it
    # as ``agg_state`` and returns the new state after the loss
    init_state: Optional[Callable] = None


def loss_and_grads(cfg, params, batch, micro: int = 1):
    """(loss, grads) of ``model.loss`` at ``params`` on ``batch``: grads a
    dict like params, in the param dtype. A leaf the loss does not reach
    (a hybrid's unused tail layer at tail 0) gets a zero gradient, as
    ``jax.value_and_grad`` gives it. With ``micro`` > 1 the batch is
    cut into ``micro`` consecutive slices whose gradients are summed in
    f32 and averaged, then cast back (``repro``'s accumulation)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    p = _unflatten(params, leaves)

    def one(b):
        loss = M.loss(p, cfg, b)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def micro_step(b, acc):
        # a function, so no trip's tensors outlive it
        loss, g = one(b)
        for a, gg in zip(acc, g):
            a += gg.float()
        return loss

    if micro <= 1:
        loss, g = one(batch)
        return loss, _unflatten(params, g)
    n = batch["tokens"].shape[0]
    if n % micro:
        raise ValueError(f"microbatch={micro} must divide the batch {n}")
    size = n // micro
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in leaves]
    tot = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in trips(micro):   # every micro-step the same ops
        tot = tot + micro_step({k: v[i * size:(i + 1) * size]
                                for k, v in batch.items()}, acc)
    return tot / micro, _unflatten(params, [
        (a / micro).to(t.dtype) for a, t in zip(acc, leaves)])


def _micro_for(microbatch, per_worker: int, seq: int) -> int:
    if microbatch is not None:
        return microbatch
    return per_worker if seq >= 2048 else 1


def stacked_grads(cfg, params, batch, n_workers: int,
                  microbatch: Optional[int] = None):
    """(mean loss over the workers, stacked grads): the global batch is
    split into ``n_workers`` equal slices, each worker's gradients are
    computed in turn and copied into a preallocated ``[W, ...]`` stack per
    leaf, in the param dtype."""
    B, seq = batch["tokens"].shape[:2]
    if B % n_workers:
        raise ValueError(f"global batch {B} must be divisible by the "
                         f"{n_workers} workers")
    per = B // n_workers
    micro = _micro_for(microbatch, per, seq)
    stack = tree_map(lambda p: torch.empty(
        (n_workers,) + tuple(p.shape), dtype=p.dtype, device=p.device),
        params)
    losses = torch.empty(n_workers, dtype=torch.float32,
                         device=batch["tokens"].device)

    def worker(w):
        # a function, so no trip's tensors outlive it
        bw = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
        loss, g = loss_and_grads(cfg, params, bw, micro)
        for s, gg in zip(_leaves(stack), _leaves(g)):
            s[w].copy_(gg)
        losses[w] = loss

    for w in trips(n_workers):   # every worker the same ops
        worker(w)
    return torch.mean(losses), stack


def _split_micro(x, n_workers: int, micro: int):
    """``repro``'s strided split: micro-step i holds block i of every
    worker, so each holds an equal worker-major block of each worker and
    ``robust_dot``'s grouping inside the backward stays per worker."""
    b = x.shape[0]
    x = x.reshape((n_workers, micro, b // (n_workers * micro)) + x.shape[1:])
    return x.transpose(0, 1).reshape((micro, b // micro) + x.shape[3:])


def make_train_step(cfg, n_workers: int, *, estimator=Estimator(),
                    mode: str = "stacked-rrs", optimizer=None,
                    lr: float = 1e-3, byzantine_frac: float = 0.0,
                    attack: str = "gaussian",
                    microbatch: Optional[int] = None,
                    with_diag: bool = False, reduce_backend: str = "rrs",
                    consensus=None, fault_plan=None,
                    weights_beta: float = 0.5, momentum: float = 0.0,
                    device=None) -> TrainSetup:
    """The step ``step_fn(params, opt_state, batch, generator=None,
    agg_state=None) -> (params, opt_state, loss[, agg_state][, caux][,
    diag])``,
    updating ``params`` and ``opt_state`` in place and returning them.
    ``generator``: a ``torch.Generator`` on the device, read by the random
    attacks (``gaussian``) and then by the consensus backend's dropout,
    where ``repro`` takes a PRNG key.

    ``estimator``: a ``core.estimator.Estimator`` or a method name.
    ``microbatch``: gradient-accumulation steps per worker (None: one
    sequence a micro-step when seq_len >= 2048, as in ``repro``).
    ``with_diag``: the step also returns an ``obs.diag.AggDiagnostics``.
    ``device``: where the step runs (the card unless named); its params
    must live there. An adaptive estimator switches a stacked mode to
    ``stacked-adaptive``: the step then takes an ``AdaptiveState`` as
    ``agg_state`` (``TrainSetup.init_state()`` makes the first) and returns
    the new one after the loss; ``weights_beta`` and ``momentum`` are its
    EMA knobs. ``reduce_backend="consensus"`` reroutes a stacked mode
    through the consensus backend (``stacked-consensus``) with
    ``consensus`` (a ``ConsensusConfig``; by default f =
    ``max(int(byzantine_frac * (W - 1)), 1)``, validated here when W > 1)
    and ``fault_plan`` (a ``FaultPlan``); the step then returns the
    ``ConsensusAux`` after the loss."""
    device = resolve_device(device)
    est = Estimator.coerce(estimator)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if with_diag and mode == "inloop":
        raise ValueError(
            "with_diag is unavailable in inloop mode: IB-RRS aggregates "
            "inside the backward pass and the per-worker gradient stack "
            "never materializes to diagnose. Use mode='stacked-rrs'.")
    if reduce_backend not in ("rrs", "consensus"):
        raise ValueError(f"unknown reduce_backend {reduce_backend!r}; "
                         "known: ('rrs', 'consensus')")
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if reduce_backend == "consensus":
        from ..dist.consensus import ConsensusConfig

        if mode == "inloop":
            raise ValueError(
                "reduce_backend='consensus' needs the materialized "
                "stacked wire; inloop (IB-RRS) aggregates inside the "
                "backward pass. Use a stacked mode.")
        mode = "stacked-consensus"
        if consensus is None:
            consensus = ConsensusConfig(
                f=max(int(byzantine_frac * (n_workers - 1)), 1))
        if n_workers > 1:
            consensus.validate(n_workers)  # fail at build, not in a step
    if est.adaptive:
        if mode == "inloop":
            raise ValueError(
                "adaptive estimators need the materialized stacked wire; "
                "inloop (IB-RRS) aggregates inside the backward pass. "
                "Use a stacked mode.")
        if mode == "stacked-consensus":
            raise ValueError(
                "adaptive estimators are unavailable on the consensus "
                "backend: peer rounds exchange coordinate slices, never "
                "complete worker rows (DESIGN.md §13). Use "
                "reduce_backend='rrs'.")
        mode = "stacked-adaptive"
    optimizer = optimizer or O.get(cfg.optimizer, lr=lr)
    init_state = None
    if est.adaptive:
        # the adaptive wire ravels every leaf: the state's momentum holds
        # one f32 per parameter
        dim = sum(math.prod(s) for _, s in tree_paths(expected_shapes(cfg)))
        init_state = lambda: est.init_adaptive_state(n_workers, dim,
                                                     device=device)
    n_byz = int(byzantine_frac * (n_workers - 1))
    mask = torch.arange(n_workers, device=device) >= (n_workers - n_byz)
    attack_fn = atk.get(attack)

    def inloop_grads(params, batch):
        B, seq = batch["tokens"].shape[:2]
        micro = microbatch if microbatch is not None else (
            max(B // n_workers, 1) if seq >= 2048 else 1)
        if B % n_workers:
            raise ValueError(f"inloop global batch {B} must be divisible "
                             f"by the {n_workers} workers")
        per_worker = B // n_workers
        if micro > 1 and per_worker % micro:
            raise ValueError(f"inloop microbatch={micro} must divide the "
                             f"per-worker batch {per_worker}")
        if micro > 1:
            batch = {k: _split_micro(v, n_workers, micro).reshape(
                (-1,) + v.shape[1:]) for k, v in batch.items()}
        with RR.robust_backward(n_workers, est):
            return loss_and_grads(cfg, params, batch, micro)

    def train_step(params, opt_state, batch, generator=None,
                   agg_state=None):
        diag = new_state = caux = None
        if mode == "stacked-adaptive" and agg_state is None:
            raise ValueError("an adaptive estimator's step needs agg_state "
                             "(TrainSetup.init_state())")
        if mode == "inloop":
            with named_span("train.worker_grads"):
                loss, agg = inloop_grads(params, batch)
        else:
            with named_span("train.worker_grads"):
                loss, grads = stacked_grads(cfg, params, batch, n_workers,
                                            microbatch)
            with named_span("train.aggregate"):
                if n_byz:
                    for g in _leaves(grads):
                        g.copy_(attack_fn(generator, g, mask))
                if mode == "stacked-adaptive":
                    res = RR.aggregate_stacked_adaptive(
                        grads, agg_state, est, with_diag=with_diag,
                        weights_beta=weights_beta, momentum=momentum)
                    agg, new_state = res[:2]
                    diag = res[2] if with_diag else None
                elif mode == "stacked-consensus":
                    res = RR.aggregate(
                        grads, mode=mode, est=est, with_diag=with_diag,
                        consensus=consensus, plan=fault_plan,
                        generator=generator,
                        pin_mask=mask if n_byz else None)
                    agg, caux = res[:2]
                    diag = res[2] if with_diag else None
                else:
                    agg = RR.aggregate(grads, mode=mode, est=est,
                                       with_diag=with_diag)
                    if with_diag:
                        agg, diag = agg
                del grads
        with named_span("train.optimizer"):
            params, opt_state = optimizer.update(agg, opt_state, params)
        out = (params, opt_state, loss)
        if new_state is not None:
            out = out + (new_state,)
        if caux is not None:
            out = out + (caux,)
        return out + (diag,) if with_diag else out

    return TrainSetup(step_fn=train_step, n_workers=n_workers,
                      optimizer=optimizer, device=device,
                      init_state=init_state)
