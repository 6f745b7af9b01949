"""The Byzantine-robust train step (``repro.train.step``'s port).

``make_train_step`` wires the paper's technique into training, with W
workers emulated on one card or held by the ranks of a
``torch.distributed`` group (``group=``: the ranks hold W / world
workers each and the aggregation rides the RRS wire,
``dist.robust_reduce.aggregate_stacked_rrs``, or, one worker a rank, the
consensus wire, ``dist.consensus.aggregate_stacked_consensus``): per-worker
gradients, the
simulated Byzantine corruption of the last rows, coordinate-wise robust
aggregation (``dist.robust_reduce``), the optimizer update. The worker
count and the group take the place of ``repro``'s mesh.
``make_serve_steps`` is ``repro``'s serving counterpart: the prefill and
decode step under a mesh context, with the caches' partition specs.

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
  the attack's. The step returns a ``ConsensusAux`` after the loss. Over
  a group (one worker a rank) the attack runs on the wire's round-0
  gathered stack, in the same order, so the step equals one process's.
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

__all__ = ["TrainSetup", "make_train_step", "make_serve_steps",
           "stacked_grads", "worker_grads", "loss_and_grads", "MODES"]

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


def loss_and_grads(cfg, params, batch, micro: int = 1, scale: float = 1.0):
    """(loss, grads) of ``model.loss`` at ``params`` on ``batch``: grads a
    dict like params, in the param dtype. A leaf the loss does not reach
    (a hybrid's unused tail layer at tail 0) gets a zero gradient, as
    ``jax.value_and_grad`` gives it. With ``micro`` > 1 the batch is
    cut into ``micro`` consecutive slices whose gradients are summed in
    f32 and averaged, then cast back (``repro``'s accumulation). The
    gradients are those of ``scale`` times the loss (a group's rank takes
    its share 1 / world of the global loss); the loss comes unscaled."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    p = _unflatten(params, leaves)

    def one(b):
        loss = M.loss(p, cfg, b)
        RR.mark_wire_products(loss, leaves)   # a group's inloop step only
        return loss.detach(), torch.autograd.grad(
            loss * scale if scale != 1.0 else loss, leaves,
            allow_unused=True, materialize_grads=True)

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
    losses, stack = worker_grads(cfg, params, batch, n_workers, microbatch)
    return torch.mean(losses), stack


def worker_grads(cfg, params, batch, n_workers: int,
                 microbatch: Optional[int] = None):
    """(each worker's loss [W] f32, stacked grads): ``stacked_grads``
    before the mean of the losses."""
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
    return losses, stack


def _check_group(world: int, n_workers: int, mode: str, est, reduce_backend,
                 n_byz: int, attack: str) -> None:
    """Refuse at build what the multi-rank wires do not take."""
    G = RR.GroupRefusal
    if n_workers % world:
        raise G(f"{n_workers} workers over a group of {world} ranks: the "
                f"world size must divide the workers")
    if est.adaptive:
        raise G(f"adaptive estimator {est.method!r} over a group of ranks: "
                "its census needs complete worker rows, and a rank holds "
                "a slice of the coordinates")
    if reduce_backend == "consensus":
        if n_workers != world:
            raise G(f"the consensus backend with {n_workers} workers over a "
                    f"group of {world} ranks: the worker dim must be fully "
                    f"sharded (one worker a rank), as repro's wire needs")
        if mode == "inloop":
            raise G("reduce_backend='consensus' needs the materialized "
                    "stacked wire; inloop (IB-RRS) aggregates inside the "
                    "backward pass. Use a stacked mode.")
        return
    if mode not in ("stacked-rrs", "inloop"):
        raise G(f"mode {mode!r} over a group of ranks: only 'stacked-rrs' "
                "and 'inloop' ride the multi-rank wire")
    if n_byz and mode == "stacked-rrs" and attack not in atk.COORDINATEWISE:
        raise G(f"attack {attack!r} over a group of ranks: it is not "
                f"coordinate-wise, so on a rank's slice of the coordinates "
                f"it would differ from the same attack on the stack "
                f"(coordinate-wise: {atk.COORDINATEWISE})")


def _sum_over_ranks(grads, group, which) -> None:
    """The leaves of ``grads`` at the indices ``which`` summed over the
    ranks in place, in f32."""
    import torch.distributed as dist

    for i, g in enumerate(_leaves(grads)):
        if i in which:
            f = g.float()
            dist.all_reduce(f, group=group)
            g.copy_(f)


def _mean_over_ranks(losses, group):
    """The mean of every rank's ``losses`` [n] (rank order)."""
    if group is None:
        return torch.mean(losses)
    n = losses.shape[0]
    out = torch.empty(n * RR.group_world(group), dtype=losses.dtype,
                      device=losses.device)
    RR.all_gather_into(out, losses.contiguous(), group)
    return torch.mean(out)


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
                    device=None, group=None) -> TrainSetup:
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
    ``ConsensusAux`` after the loss.

    ``group``: a ``torch.distributed`` process group whose ranks hold the
    workers, ``n_workers / world`` each (rank r the r-th block; the world
    size must divide ``n_workers``). Every rank calls the step with the
    same global batch and params and takes its own workers' rows of the
    batch. ``stacked-rrs`` sends the rank's stack down the RRS wire
    (``dist.robust_reduce.aggregate_stacked_rrs``), the attack applied to
    the received slice (so only coordinate-wise attacks,
    ``core.attacks.COORDINATEWISE``); ``inloop`` sends each product's
    ``dW`` stack down it inside the backward and sums over the ranks,
    with one f32 ``all_reduce`` a leaf, only the leaves whose gradient is
    not wholly wire products (the norms, the embedding, tied or not: its
    lookup's gradient is one partial a rank;
    ``dist.robust_reduce.mark_wire_products``). ``reduce_backend=
    "consensus"`` over a group needs one worker a rank (``n_workers`` =
    world) and runs the consensus wire over the ranks
    (``dist.consensus.aggregate_stacked_consensus``), every attack on its
    round-0 gathered stack; each rank's ``generator`` must hold the same
    state. The optimizer then runs on replicated params, the same on every
    rank; the loss is the mean over all the workers. Every other mode, an
    adaptive estimator, the consensus backend at other than one worker a
    rank or with ``inloop``, and the attacks that are not coordinate-wise
    under ``stacked-rrs`` raise ``GroupRefusal``."""
    device = resolve_device(device)
    est = Estimator.coerce(estimator)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    world = RR.group_world(group)
    if world > 1:
        _check_group(world, n_workers, mode, est, reduce_backend,
                     int(byzantine_frac * (n_workers - 1)), attack)
    else:
        group = None
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

    w_loc = n_workers // world

    def own_rows(batch):
        """This rank's workers' rows of the global batch."""
        B = batch["tokens"].shape[0]
        if B % n_workers:
            raise ValueError(f"global batch {B} must be divisible by the "
                             f"{n_workers} workers")
        if group is None:
            return batch
        import torch.distributed as dist

        per = B // world
        r = dist.get_rank(group)
        return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}

    def inloop_grads(params, batch):
        batch = own_rows(batch)
        B, seq = batch["tokens"].shape[:2]
        micro = microbatch if microbatch is not None else (
            max(B // w_loc, 1) if seq >= 2048 else 1)
        per_worker = B // w_loc
        if micro > 1 and per_worker % micro:
            raise ValueError(f"inloop microbatch={micro} must divide the "
                             f"per-worker batch {per_worker}")
        if micro > 1:
            batch = {k: _split_micro(v, w_loc, micro).reshape(
                (-1,) + v.shape[1:]) for k, v in batch.items()}
        with RR.robust_backward(n_workers, est, group=group) as rb:
            loss, grads = loss_and_grads(cfg, params, batch, micro,
                                         scale=1.0 / world)
        if group is not None:   # the leaves not wholly on the wire
            with named_span("train.sum_over_ranks"):
                _sum_over_ranks(grads, group, rb.summed)
            loss = _mean_over_ranks(loss.reshape(1), group)
        return loss, grads


    def train_step(params, opt_state, batch, generator=None,
                   agg_state=None):
        diag = new_state = caux = None
        if mode == "stacked-adaptive" and agg_state is None:
            raise ValueError("an adaptive estimator's step needs agg_state "
                             "(TrainSetup.init_state())")
        if mode == "inloop":
            with named_span("train.worker_grads"):
                loss, agg = inloop_grads(params, batch)
        elif group is not None:
            with named_span("train.worker_grads"):
                losses, grads = worker_grads(cfg, params, own_rows(batch),
                                             w_loc, microbatch)
                loss = _mean_over_ranks(losses, group)
            with named_span("train.aggregate"):
                hit = ((lambda v: attack_fn(generator, v, mask)) if n_byz
                       else None)
                if mode == "stacked-consensus":
                    res = RR.aggregate(
                        grads, mode=mode, est=est, with_diag=with_diag,
                        consensus=consensus, plan=fault_plan,
                        generator=generator,
                        pin_mask=mask if n_byz else None, group=group,
                        attack=hit)
                    agg, caux = res[:2]
                    diag = res[2] if with_diag else None
                else:
                    agg = RR.aggregate_stacked_rrs(
                        grads, group, est, with_diag=with_diag, attack=hit)
                    if with_diag:
                        agg, diag = agg
                del grads
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


def make_serve_steps(cfg, mesh, *, shape, window="cfg"):
    """``(prefill_fn, decode_fn, cache_shapes, specs, batch_axes)``
    (``repro``'s ``make_serve_steps``): ``prefill_fn(params, batch)`` and
    ``decode_fn(params, caches, token)`` run ``models.model.prefill``
    (last-position logits, caches of ``shape.seq_len``) and
    ``decode_step`` under ``dist.ctx.mesh_context(mesh)``;
    ``cache_shapes()`` is the decode cache of ``shape`` on the meta device
    (nothing allocated) and ``specs()`` its ``dist.sharding.cache_specs``
    with the batch on ``batch_axes`` (``batch_axes_for(mesh,
    shape.global_batch)``). ``mesh`` is a ``launch.mesh.MeshShape`` or a
    ``DeviceMesh``."""
    from ..dist import ctx as CTX
    from ..dist import sharding as S

    batch_axes = S.batch_axes_for(mesh, shape.global_batch)

    def prefill_fn(params, batch):
        with CTX.mesh_context(mesh):
            return M.prefill(params, cfg, batch, window=window,
                             cache_len=shape.seq_len, last_only=True)

    def decode_fn(params, caches, token):
        with CTX.mesh_context(mesh):
            return M.decode_step(params, cfg, caches, token, window=window)

    def cache_shapes():
        return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                            window=window, device="meta")

    def specs():
        return S.cache_specs(cfg, cache_shapes(), mesh, batch_axes,
                             global_batch=shape.global_batch)

    return prefill_fn, decode_fn, cache_shapes, specs, batch_axes
