"""Byzantine-robust gradient reduction (``repro.dist.robust_reduce``'s
port), over workers emulated in one process or held by the ranks of a
``torch.distributed`` process group.

The semantics are ``repro``'s: coordinate-wise robust aggregation (VRMOM
eq. 7 / MOM / trimmed mean / mean) of per-worker gradients stacked on a
leading worker dim, with the estimator given by one
``core.estimator.Estimator`` spec.

* ``aggregate_stacked_auto`` — the estimator on each leaf's ``[W, numel]``
  stack (``repro``'s jit-native path). A stack in bf16 goes to the kernel
  (B1) as it is: B1 reads bf16, computes in f32 and writes bf16, which is
  bitwise ``repro``'s cast to f32, aggregate, cast back, without an f32
  copy of the stack (at full width that copy would not fit beside it).
* ``aggregate_stacked_rrs`` — ``repro``'s Robust-Reduce-Scatter wire over
  the ranks of a group, each holding ``W_loc`` rows of the stack: every
  leaf raveled to f32 and concatenated in tree order, zero-padded to a
  multiple of the world size, one ``all_to_all_single`` (each rank then
  holds all W workers' values of its slice of coordinates, rows in rank
  order), the estimator on that slice (B1 on the card, once a call; the
  plain version on the CPU), one ``all_gather`` back, the padding cut and
  each leaf cast back to its dtype. Constant collective rounds whatever
  W: the paper's one-round property. Without a group, or on one rank, it
  is ``aggregate_stacked_auto``. The collectives take the tensors where
  they lie: ``gloo`` and ``nccl`` both take CUDA tensors (``gloo`` stages
  them through the host itself), so the wire never copies to the host.
* ``aggregate`` — the mode dispatcher of the train step: ``stacked-auto``
  (``auto``), ``stacked-rrs``, ``mean`` and ``stacked-consensus``; over a
  group of ranks ``stacked-rrs`` and ``stacked-consensus``
  (``GroupRefusal`` for the rest).
* ``robust_backward`` + ``robust_dot`` — in-backward aggregation
  (``repro``'s IB-RRS): a matmul whose weight gradient is the robust
  aggregate of the per-worker partial ``dW``, computed inside the
  backward, so no stacked gradient of the whole model exists; over a
  group the ``dW`` stack rides the RRS wire, and ``mark_wire_products``
  (called between the forward and the backward) leaves only the
  gradients that are not wholly such products to be summed over the
  ranks afterwards.
* ``aggregate_stacked_adaptive`` — the adaptive tier (``core.adaptive``)
  on the whole stacked tree with an explicit ``AdaptiveState`` carry;
  ``aggregate_stacked_auto`` sends a stateless adaptive estimator down the
  same wire. The census needs complete worker rows, so ``repro`` ravels
  every leaf onto one f32 ``[W, C]`` wire; at full width that wire (55 GB
  for qwen3-1.7b at W = 8) would not fit beside the bf16 stack. This wire
  computes the same function in column blocks of the leaves' own stacks:
  a census pass accumulates each row's squared deviation from the
  coordinatewise median and the rows' squared distances in f32, then a
  pass runs the rungs (``vrmom_adaptive``) or the Weiszfeld iterations
  (``auto_gm``; one ``[C]`` f32 iterate, each pass the distances from it
  and the next iterate) block by block. Only the f32 summation order
  differs from ``repro``.
* ``aggregate_stacked_auto(reduce_backend="consensus")`` and
  ``aggregate(mode="stacked-consensus")`` — the peer-to-peer consensus
  emulation (``dist.consensus``) on the stacked tree. ``repro`` ravels it
  onto the same f32 ``[W, C]`` wire; this one runs every round on a column
  block before the next block (the rounds are coordinate-wise, so that is
  exact): one set of reception matrices serves every block, the spreads
  are maxima over blocks, and the stragglers' history and the pinned
  rows' ``v0`` are kept per block. Over the ranks of a group, one peer a
  rank, ``aggregate(mode="stacked-consensus", group=)`` runs
  ``dist.consensus.aggregate_stacked_consensus``, ``repro``'s
  ``shard_map`` wire: one ``all_gather`` a round in column blocks of the
  raveled f32 vector, each rank its own receiver's trim.
* ``aggregate_symmetric_stacked`` — the inference layer's stacks of
  symmetric matrices.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch

from ..core import adaptive as AD
from ..core.estimator import Estimator
from ..obs.trace import named_span
from ..tree import leaves as _leaves, tree_map, unflatten as _unflatten
from . import ctx as CTX

__all__ = ["aggregate", "aggregate_stacked_auto", "aggregate_stacked_rrs",
           "aggregate_stacked_adaptive", "aggregate_symmetric_stacked",
           "robust_backward", "mark_wire_products", "robust_dot",
           "robust_dot_enabled",
           "weiszfeld_stacked", "group_world", "GroupRefusal", "WIRE_CHUNK"]

EstimatorLike = Union[str, Estimator]

# columns made f32 at a time on the block wires: a leaf's stack on the
# adaptive and the one-process consensus wire, the raveled vector on the
# consensus wire over ranks
WIRE_CHUNK = 1 << 22


class GroupRefusal(ValueError):
    """What the multi-rank wires do not take: a mode or an attack that
    needs whole worker rows on the RRS wire, a worker count the ranks do
    not divide, or other than one worker a rank on the consensus wire."""


def all_gather_into(out, x, group) -> None:
    """``out`` [world * n] = every rank's ``x`` [n] in rank order: one
    all_gather into one tensor (``all_gather_single``, as torch 2.13
    names ``all_gather_into_tensor``; gloo's list form is slower)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def group_world(group) -> int:
    """Ranks of ``group`` (1 without one)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _wire_estimator(est: EstimatorLike) -> Estimator:
    """Coerce, and refuse whole-vector estimators: coordinate-wise
    aggregation only (the adaptive tier takes its own wire)."""
    return Estimator.coerce(est).require_coordinatewise(
        "chunked/RRS aggregation (dist.robust_reduce)")


def _with_tree_diag(grads, out):
    """``(out, obs.diag.tree_diagnose(grads, out))``: the per-worker
    deviation diagnostics of a stacked tree against its aggregate, the
    same for every mode."""
    from ..obs import diag as OD
    from ..obs.trace import named_span

    with named_span("obs.tree_diagnose"):
        return out, OD.tree_diagnose(grads, out)


def _aggregate_leaf(est: Estimator, g):
    """One ``[W, ...]`` leaf -> ``[...]`` in its dtype. The kernel backend
    takes the stack in its own dtype (f32 math inside); the others get
    ``repro``'s f32 cast."""
    flat = g.reshape(g.shape[0], -1)
    if est.resolve_backend() == "cuda":
        out = est.apply(flat, axis=0)
    else:
        out = est.apply(flat.float(), axis=0).to(g.dtype)
    return out.reshape(g.shape[1:])


def aggregate_stacked_auto(grads, est: EstimatorLike = "vrmom", *,
                           with_diag: bool = False,
                           reduce_backend: str = "direct", consensus=None,
                           plan=None, generator=None, draws=None,
                           pin_mask=None):
    """The estimator on every leaf of a stacked tree (leaves ``[W, ...]``,
    or one such tensor); returns the aggregate without the worker dim,
    and with ``with_diag`` the pair ``(aggregate,
    obs.diag.AggDiagnostics)``. An adaptive estimator takes the full-row
    adaptive wire (its census needs complete worker rows: a census per
    leaf would fragment the signal).

    ``reduce_backend="consensus"`` swaps the one-shot estimator for the
    peer-to-peer consensus emulation on the block-by-block wire of the
    module docstring, under ``consensus`` (a ``ConsensusConfig``) and the
    optional ``plan`` (a ``FaultPlan``), its dropout drawn from
    ``generator`` or handed in as ``draws`` ``[p_end, W, W]``; ``pin_mask``
    [W] marks persistent Byzantine senders. It returns ``(tree,
    ConsensusAux)``, with ``with_diag`` the diagnostics last; each leaf
    comes back in its dtype."""
    if reduce_backend not in ("direct", "consensus"):
        raise ValueError(f"unknown reduce_backend {reduce_backend!r}; "
                         "known: ('direct', 'consensus')")
    est = Estimator.coerce(est)
    if est.adaptive:
        est.require_stackable("full-stack aggregation (dist.robust_reduce)")
    else:
        est = _wire_estimator(est)
    if reduce_backend == "consensus":
        out, aux = _consensus_wire(grads, est, consensus, plan, generator,
                                   draws, pin_mask)
        if with_diag:
            return out, aux, _with_tree_diag(grads, out)[1]
        return out, aux
    if est.adaptive:
        out = _adaptive_wire(grads, est)[0]
    else:
        out = tree_map(lambda g: _aggregate_leaf(est, g), grads)
    if with_diag:
        return _with_tree_diag(grads, out)
    return out


def aggregate_stacked_rrs(grads, group=None, est: EstimatorLike = "vrmom",
                          *, with_diag: bool = False,
                          attack: Optional[Callable] = None):
    """Robust-Reduce-Scatter of a stacked tree over the ranks of ``group``
    (module docstring). ``grads``: this rank's leaves ``[W_loc, ...]``,
    the same tree and ``W_loc`` on every rank; rank r holds workers ``r *
    W_loc`` to ``(r + 1) * W_loc - 1``. Returns the aggregate (the worker
    dim removed, each leaf in its dtype) on every rank, and with
    ``with_diag`` the pair ``(aggregate, obs.diag.AggDiagnostics)``: each
    rank adds ``obs.diag``'s per-row moments over its slice, and one
    ``all_reduce`` sums them.

    ``attack``: a callable ``[W, c] -> [W, c]`` (a coordinate-wise attack
    with its mask and generator bound) applied to the received slice
    before the estimator, piece by piece of each leaf in the leaf's own
    dtype, so it computes what the same attack on each leaf's stack does.

    Without a group, or on one rank, this is ``aggregate_stacked_auto``
    (``repro`` at one worker shard), the attack applied leaf by leaf."""
    est = _wire_estimator(est)
    nw = group_world(group)
    if nw <= 1:
        if attack is not None:
            grads = tree_map(
                lambda g: attack(g.reshape(g.shape[0], -1)).reshape(g.shape),
                grads)
        return aggregate_stacked_auto(grads, est, with_diag=with_diag)
    import torch.distributed as dist

    leaves = list(_leaves(grads))
    w_loc, dev = leaves[0].shape[0], leaves[0].device
    W = w_loc * nw
    rank = dist.get_rank(group)
    sizes = [g[0].numel() for g in leaves]
    n = sum(sizes)
    c = -(-n // nw)                      # the slice each rank aggregates
    f32 = dict(dtype=torch.float32, device=dev)
    with named_span("rrs.pack"):
        # send[r] holds this rank's rows of the coordinates rank r owns
        send = torch.empty((nw, w_loc, c), **f32)
        for r in range(n // c, nw):      # the zero padding past n
            send[r, :, max(n - r * c, 0):] = 0
        for lo, hi, i, a in _pieces(sizes, 0, nw * c, c):
            send[lo // c, :, lo % c:lo % c + hi - lo] = \
                leaves[i].reshape(w_loc, -1)[:, a:a + hi - lo]
    recv = torch.empty((nw, w_loc, c), **f32)
    with named_span("rrs.all_to_all"):
        dist.all_to_all_single(recv, send, group=group)
    del send
    wire = recv.view(W, c)               # rows in rank order
    base = rank * c
    if attack is not None:
        with named_span("rrs.attack"):
            for lo, hi, i, _ in _pieces(sizes, base, base + c, c):
                seg = wire[:, lo - base:hi - base]
                seg.copy_(attack(seg.to(leaves[i].dtype).contiguous()))
    with named_span("rrs.estimator"):
        agg = est.apply(wire, axis=0)    # [c] f32: B1 on the card
    diag = None
    if with_diag:
        from ..obs import diag as OD

        # the moments of the leaves as they come back: each piece's
        # aggregate rounded to its leaf's dtype, as tree_diagnose sees it
        valid = max(min(c, n - base), 0)
        held = agg
        for lo, hi, i, _ in _pieces(sizes, base, base + c, c):
            if leaves[i].dtype != torch.float32:
                if held is agg:
                    held = agg.clone()
                held[lo - base:hi - base] = \
                    agg[lo - base:hi - base].to(leaves[i].dtype).float()
        acc = OD._zeros(W, dev)
        OD._add_moments(acc, wire[:, :valid], held[:valid])
        del held
        sums = torch.cat([acc[0], acc[1], acc[2].reshape(1)])
        dist.all_reduce(sums, group=group)
        diag = OD.finalize_diag(sums[:W], sums[W:2 * W], sums[2 * W])
    del recv, wire
    full = torch.empty(nw * c, **f32)
    with named_span("rrs.all_gather"):
        all_gather_into(full, agg, group)
    outs, off = [], 0
    for g, size in zip(leaves, sizes):
        outs.append(full[off:off + size].reshape(g.shape[1:]).to(g.dtype))
        off += size
    out = _unflatten(grads, outs)
    return (out, diag) if with_diag else out


def _pieces(sizes, lo: int, hi: int, c: int):
    """(start, end, leaf index, leaf column) of each run of wire
    coordinates in ``[lo, hi)`` that lies in one leaf and one slice of
    ``c`` coordinates; the wire is the leaves' columns end to end."""
    off = 0
    for i, size in enumerate(sizes):
        a, b = max(lo, off), min(hi, off + size)
        while a < b:
            e = min(b, (a // c + 1) * c)
            yield a, e, i, a - off
            a = e
        off += size


def _consensus_wire(grads, est: Estimator, config, plan, generator, draws,
                    pin_mask):
    """(tree, ConsensusAux): ``dist.consensus``' run and decision on the
    raveled ``[W, C]`` stack of a tree, one ``WIRE_CHUNK`` column block at
    a time (module docstring)."""
    from . import consensus as CS

    leaves = list(_leaves(grads))
    W, dev = leaves[0].shape[0], leaves[0].device
    est, config, plan = CS._prep(W, est, config, plan)
    p_end = config.phases(plan)
    views = CS._round_views(plan, W, p_end, W - config.f, draws=draws,
                            generator=generator, device=dev)
    pin = CS._pin(pin_mask, W, dev)
    honest_end = CS._honest_end(plan, W, p_end, pin, dev)
    outs = [torch.empty(g.shape[1:], dtype=g.dtype, device=g.device)
            for g in leaves]
    spreads = final = None
    with named_span("consensus.round_loop"):
        for _, i, cols, block in _blocks(leaves):
            finals, sp = CS._iterate(block.float(), est, config, plan, views,
                                     pin)
            fs = CS._spread(finals, honest_end)
            spreads = sp if spreads is None else torch.maximum(spreads, sp)
            final = fs if final is None else torch.maximum(final, fs)
            outs[i].view(-1)[cols] = CS._decide(finals, config, plan,
                                                pin is not None)
    return (_unflatten(grads, outs),
            CS._aux(views, spreads, final, config.eps, ()))


def aggregate_stacked_adaptive(grads, state, est: EstimatorLike, *,
                               with_diag: bool = False,
                               weights_beta: float = 0.5,
                               momentum: float = 0.0):
    """Stateful adaptive aggregate of a stacked tree (leaves ``[W, ...]``):
    ``(tree, new_state)``, with ``with_diag`` ``(tree, new_state,
    AggDiagnostics)``. The census, the EMA of the trust weights and
    ``alpha_hat``, the aggregate and its momentum are ``repro``'s
    ``apply_adaptive`` on the raveled ``[W, C]`` wire; ``state.momentum``
    is ``[C]`` f32 in ``repro``'s leaf order (``tree.paths``), so a
    ``repro`` state carries across. Each step writes a new ``[C]``
    momentum beside the state's."""
    est = Estimator.coerce(est).require_stackable(
        "full-stack adaptive aggregation (dist.robust_reduce)")
    if not est.adaptive:
        raise ValueError(
            f"aggregate_stacked_adaptive needs an adaptive estimator, "
            f"got {est.method!r}")
    out, new_state = _adaptive_wire(grads, est, state,
                                    weights_beta=weights_beta,
                                    momentum=momentum)
    if with_diag:
        return out, new_state, _with_tree_diag(grads, out)[1]
    return out, new_state


def _blocks(leaves):
    """(wire offset, leaf index, leaf column slice, [W, c] block of the
    leaf's stack in its own dtype) over every leaf, ``WIRE_CHUNK`` columns
    at a time, in ``repro``'s ravel order."""
    chunk = WIRE_CHUNK
    off = 0
    for i, g in enumerate(leaves):
        flat = g.reshape(g.shape[0], -1)
        n = flat.shape[1]
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            yield off + a, i, slice(a, b), flat[:, a:b]
        off += n


def _wire_census(leaves, kernel: bool) -> AD.StackCensus:
    """The census of the raveled stack, accumulated over its column
    blocks by ``core.adaptive.census_of_blocks``."""
    return AD.census_of_blocks((block for *_, block in _blocks(leaves)),
                               kernel)


def weiszfeld_stacked(grads, pi, iters: int = 8, eps: float = 1e-8):
    """``core.aggregators.weiszfeld`` of the raveled ``[W, C]`` stack of a
    tree under row weights ``pi`` [W] -> the ``[C]`` f32 iterate, in
    column blocks: the first pass makes the weighted mean and the rows'
    distances from it, each later pass the next iterate from the previous
    distances and the distances from it (the last pass skips them).
    ``pi`` all ones is the geometric median of the stack."""
    return _weiszfeld_blocks(list(_leaves(grads)), pi, iters, eps)


def _weiszfeld_blocks(leaves, pi, iters: int, eps: float):
    W, dev = leaves[0].shape[0], leaves[0].device
    C = sum(g[0].numel() for g in leaves)
    pi = pi.float()
    y = torch.empty(C, dtype=torch.float32, device=dev)
    w, norm = pi, torch.sum(pi)
    for it in range(iters + 1):
        dist2 = torch.zeros(W, dtype=torch.float32, device=dev)
        for o, _, _, block in _blocks(leaves):
            yc = y[o:o + block.shape[1]]
            yc.copy_(torch.sum(block * w[:, None], dim=0) / norm)
            if it < iters:
                dist2 += torch.sum((block - yc) ** 2, dim=-1)
        if it < iters:
            w = pi / torch.sqrt(dist2 + eps)
            norm = torch.sum(w)
    return y


def _adaptive_wire(grads, est: Estimator, state=None, *,
                   weights_beta: float = 0.5, momentum: float = 0.0):
    """(tree, new_state or None): ``est``'s adaptive aggregate of a stacked
    tree, stateless (``state=None``: the census weights and ``alpha_hat``,
    ``core.adaptive``'s ``auto_gm``/``vrmom_adaptive``) or stateful
    (``apply_adaptive``), on the block-by-block wire of the module
    docstring. Every leaf comes back in its dtype."""
    leaves = list(_leaves(grads))
    kernel = AD._kernel(est.backend)
    cen = _wire_census(leaves, kernel)
    if state is None:
        w, alpha, sus = cen.weights, cen.alpha_hat, cen.suspected
    else:
        w, alpha = AD.ema(state, cen, weights_beta)
        sus = w < 0.5
        step = state.step + 1
    outs = [torch.empty(g.shape[1:], dtype=g.dtype, device=g.device)
            for g in leaves]
    y = (_weiszfeld_blocks(leaves, w, 8, 1e-8)
         if est.method == "auto_gm" else None)
    if state is not None:
        # auto_gm's iterate becomes the new momentum block by block, so
        # the step holds two [C] f32 vectors, not three
        new_m = y if y is not None else torch.empty_like(state.momentum)
    for o, i, cols, block in _blocks(leaves):
        c = block.shape[1]
        if y is not None:
            agg = y[o:o + c]
        else:
            f = block.float().contiguous()[None]
            center = AD._coordinatewise(f, "median", 0, kernel)
            agg = AD._impute_and_climb(f, sus[None], center, alpha, est.K,
                                       kernel)[0]
        m = None
        if state is not None:
            agg, m = AD.momentum_update(state.momentum[o:o + c], agg,
                                        momentum, step)
        outs[i].view(-1)[cols] = agg
        if m is not None:
            new_m[o:o + c] = m
    tree = _unflatten(grads, outs)
    if state is None:
        return tree, None
    return tree, AD.AdaptiveState(weights=w, momentum=new_m, step=step,
                                  alpha_hat=alpha)


def aggregate(grads, *, mode: str = "stacked-rrs",
              est: EstimatorLike = "vrmom", with_diag: bool = False,
              consensus=None, plan=None, generator=None, draws=None,
              pin_mask=None, group=None, attack: Optional[Callable] = None):
    """Mode dispatcher of ``train/step.py``. ``stacked-rrs`` runs the RRS
    wire (``aggregate_stacked_rrs``) over ``group``; without one, or on one
    rank, it runs ``aggregate_stacked_auto``, as ``repro``'s wire does at
    one worker shard (refusing what is not coordinate-wise, as that wire
    does). ``stacked-auto`` (``auto``) is ``aggregate_stacked_auto``;
    ``mean`` is the plain mean over the workers, the non-robust baseline,
    accumulated in f32 without an f32 copy of the stack. ``with_diag``
    returns ``(aggregate, AggDiagnostics)`` for every mode.
    ``stacked-consensus`` runs the consensus backend
    (``aggregate_stacked_auto``'s consensus arguments; ``(aggregate,
    ConsensusAux[, diag])``); a single worker has nothing to disagree
    about and runs it with f = 0, as ``repro``'s wire does. Over a group of
    several ranks ``stacked-rrs`` runs the RRS wire and
    ``stacked-consensus`` the consensus wire over the ranks
    (``dist.consensus.aggregate_stacked_consensus``, one worker a rank);
    every other mode raises ``GroupRefusal``: it wants whole worker rows in
    one place. ``attack``: a callable ``[W, ...] -> [W, ...]`` (its mask
    and generator bound) that the wires apply where they hold the rows
    (``aggregate_stacked_rrs``: a coordinate-wise attack on the rank's
    slice; the consensus wire over ranks: round 0's gathered stack);
    elsewhere it is applied to each leaf's stack first."""
    nw = group_world(group)
    if nw > 1 and mode not in ("stacked-rrs", "stacked-consensus"):
        raise GroupRefusal(
            f"aggregation mode {mode!r} over a group of {nw} ranks: only "
            "'stacked-rrs' and 'stacked-consensus' ride the multi-rank "
            "wires")
    if mode == "stacked-rrs":
        return aggregate_stacked_rrs(grads, group, est, with_diag=with_diag,
                                     attack=attack)
    if mode == "stacked-consensus" and nw > 1:
        from .consensus import aggregate_stacked_consensus

        return aggregate_stacked_consensus(
            grads, group, est, config=consensus, plan=plan,
            generator=generator, draws=draws, pin_mask=pin_mask,
            attack=attack, with_diag=with_diag)
    if attack is not None:
        grads = tree_map(attack, grads)
    if mode == "stacked-consensus":
        W = next(iter(_leaves(grads))).shape[0]
        cfg = consensus
        if W <= 1:
            from .consensus import ConsensusConfig

            cfg = (cfg if cfg is not None else ConsensusConfig())._replace(
                f=0)
        return aggregate_stacked_auto(
            grads, est, with_diag=with_diag, reduce_backend="consensus",
            consensus=cfg, plan=plan, generator=generator, draws=draws,
            pin_mask=pin_mask)
    if mode in ("stacked-auto", "auto"):
        return aggregate_stacked_auto(grads, est, with_diag=with_diag)
    if mode == "mean":
        out = tree_map(lambda g: torch.mean(g, dim=0, dtype=torch.float32
                                            ).to(g.dtype), grads)
        if with_diag:
            return _with_tree_diag(grads, out)
        return out
    raise ValueError(f"unknown aggregation mode {mode!r}")


def aggregate_symmetric_stacked(mats, est: EstimatorLike = "vrmom"):
    """Robustly aggregate a stack of symmetric matrices ``[.., W, p, p]``
    over its worker axis W (leading axes are replications).

    Used by the inference layer for the per-machine Hessian and
    gradient-second-moment stacks. Only the ``p(p+1)/2`` upper-triangle
    coordinates are aggregated, as one ``[W, R·p(p+1)/2]`` stack through
    the Estimator, and the aggregated triangle is mirrored back, so the
    output is *exactly* symmetric (which downstream solves deserve).
    """
    est = Estimator.coerce(est).require_stackable(
        "symmetric-stack aggregation (dist.robust_reduce)")
    if mats.ndim < 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"expected [.., W, p, p] symmetric stack, got "
                         f"{tuple(mats.shape)}")
    p = mats.shape[-1]
    iu = torch.triu_indices(p, p, device=mats.device)
    tri = mats[..., iu[0], iu[1]].float()          # [.., W, p(p+1)/2]
    agg = est.apply(tri, axis=tri.ndim - 2)        # [.., p(p+1)/2]
    out = torch.zeros(agg.shape[:-1] + (p, p), dtype=torch.float32,
                      device=mats.device)
    out[..., iu[0], iu[1]] = agg
    out = out + torch.triu(out, 1).transpose(-1, -2)
    return out.to(mats.dtype)


# ---------------------------------------------------------------------------
# In-backward aggregation: robust_dot under a robust_backward context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def robust_backward(n_workers: int, est: EstimatorLike = "vrmom",
                    group=None):
    """While active, the layers' ``_dot`` routes 3-D x 2-D products
    through ``robust_dot``, so each weight gradient is aggregated over the
    ``n_workers`` workers inside the backward. Over ``group`` the ranks
    hold ``n_workers / world`` workers each (``GroupRefusal`` unless the
    world size divides it); a rank's batch is its workers' equal
    worker-major blocks. Yields the pushed ``RobustBackwardState``: over
    a group, its ``summed`` lists the leaves ``mark_wire_products`` left
    to be summed over the ranks."""
    nw = group_world(group)
    if n_workers % nw:
        raise GroupRefusal(f"{n_workers} workers over a group of {nw} "
                           f"ranks: the world size must divide the workers")
    state = CTX.RobustBackwardState(
        int(n_workers) // nw, _wire_estimator(est),
        group if nw > 1 else None, set() if nw > 1 else None)
    CTX.push_robust_backward(state)
    try:
        yield state
    finally:
        CTX.pop_robust_backward()


def mark_wire_products(loss, leaves) -> None:
    """Between the forward and the backward of ``loss`` over a group (a
    no-op otherwise): walk its autograd graph from ``loss``; a leaf of
    ``leaves`` that some path reaches other than through a ``robust_dot``
    weight (a norm, the embedding lookup, the tied embedding's lookup half)
    has a partial gradient on each rank, and its index joins the active
    state's ``summed``. Each ``robust_dot`` whose weight reaches no such
    leaf is marked to return the wire's aggregate on every rank, so its
    leaves need no sum; the others return it on rank 0 alone, zeros
    elsewhere, and the sum counts it once. The walk is the same for
    every micro-step of one step."""
    state = CTX.robust_backward_state()
    if state is None or state.group is None or loss.grad_fn is None:
        return
    dot_node = _RobustDot._backward_cls
    ids = {id(t): i for i, t in enumerate(leaves)}
    plain, dots, seen = set(), [], set()
    todo = [loss.grad_fn]
    while todo:          # what the loss reaches other than through a weight
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None and id(var) in ids:
            plain.add(ids[id(var)])
        edges = node.next_functions
        if type(node) is dot_node:
            dots.append(node)
            edges = edges[:1]            # x's edge; the weight's is the wire
        todo.extend(f for f, _ in edges)

    def reaches_plain(node, memo) -> bool:
        """Whether a weight's graph reaches a leaf that needs the sum."""
        if node is None:
            return False
        if node not in memo:
            var = getattr(node, "variable", None)
            memo[node] = (var is not None and ids.get(id(var)) in plain) \
                or any(reaches_plain(f, memo) for f, _ in node.next_functions)
        return memo[node]

    memo: dict = {}
    for node in dots:
        node.everywhere = not reaches_plain(node.next_functions[1][0], memo)
    state.summed.update(plain)


def robust_dot_enabled() -> bool:
    return CTX.robust_backward_state() is not None


class _RobustDot(torch.autograd.Function):
    """``x @ w`` (x [B, S, D], w [D, F]) whose backward returns ``dx = dy
    @ wᵀ`` and, for ``dw``, the Estimator's aggregate of the per-worker
    partial products ``x_wᵀ dy_w`` in f32 (B1 on the card), cast to w's
    dtype. As in ``repro``, each worker's ``dW`` is its share of the
    gradient of the global loss, so with the mean the result is the
    global ``dW / W`` (ROADMAP.md §C). Each worker's product is its own
    ``torch.mm``: a batched product's bits depend on the batch on the
    card (cuBLAS), and one worker's ``dW`` must not depend on how many
    workers share its process.

    Over a group (``group``: this rank holds ``n_workers`` of the workers)
    the rank's ``[n_workers, D, F]`` stack rides the RRS wire, and every
    rank gets the aggregate. Every rank returns it when
    ``mark_wire_products`` found that the weight reaches only leaves
    whose gradients are wholly such products (``everywhere``); otherwise
    only rank 0 returns it, the others zeros, because the caller sums
    that leaf's gradient over the ranks once the backward is done (the
    norms and the embedding lookup have one partial gradient a rank), and
    the sum must count the aggregate once."""

    @staticmethod
    def forward(ctx, x, w, n_workers: int, est: Estimator, group=None):
        ctx.save_for_backward(x, w)
        ctx.n_workers, ctx.est, ctx.group = n_workers, est, group
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nw, B, group = ctx.n_workers, x.shape[0], ctx.group
        dx = (dy @ w.t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        if nw > 1 and B % nw:
            raise ValueError(
                f"robust_dot: batch dim {B} is not divisible by the {nw} "
                f"workers; dW cannot be grouped per worker")
        D, F = w.shape
        if nw <= 1 and group is None:
            dw = x.reshape(-1, D).float().t() @ dy.reshape(-1, F).float()
            return dx, dw.to(w.dtype), None, None, None
        xw = x.reshape(nw, -1, D).float()
        dyw = dy.reshape(nw, -1, F).float()
        dws = torch.empty((nw, D, F), dtype=torch.float32, device=x.device)
        for i in range(nw):
            torch.mm(xw[i].t(), dyw[i], out=dws[i])
        del xw, dyw
        if group is None:
            dw = aggregate_stacked_auto(dws, ctx.est)
        else:
            import torch.distributed as dist

            dw = aggregate_stacked_rrs(dws, group, ctx.est)
            if not getattr(ctx, "everywhere", False) \
                    and dist.get_rank(group) != 0:
                dw = torch.zeros_like(dw)
        del dws
        return dx, dw.to(w.dtype), None, None, None


def robust_dot(x, w):
    """``x @ w`` (x [B, S, D], w [D, F]) whose ``dW`` is the robust
    aggregate of per-worker ``dW`` under an active ``robust_backward``
    context (plain ``x @ w`` without one). The worker count must divide
    B."""
    state = CTX.robust_backward_state()
    if state is None:
        return x @ w
    return _RobustDot.apply(x, w, state.n_workers, state.estimator,
                            state.group)
