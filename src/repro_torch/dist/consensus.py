"""Decentralized approximate consensus (``repro.dist.consensus``' port):
the single-device emulation of the peer-to-peer wire.

The coordinator-free alternative to Robust-Reduce-Scatter: every worker is
a peer. Each round a worker broadcasts its current value vector, f-trims
whatever arrives, and moves to the trimmed aggregate; after a static
number of rounds

    ``p_end = ceil(log(eps / K) / log(1/2))``

(the JACM86 phase bound for convergence factor 1/2 per round, with ``K =
init_range`` the assumed bound on the initial spread) every honest worker
holds the same value to within ``eps``. Validity requires ``n > 5f``,
refused before any compute, and each round proceeds on any ``n - f``
received values (the quorum), so the iteration tolerates the message
dropout, stragglers and crashes of a :class:`dist.faults.FaultPlan`.

``consensus_iterate`` / ``consensus_aggregate`` run every peer of a local
``[..., n, C]`` stack on one device (every receiver's view is
materialized, ``O(n^2 C)`` on the fault path); leading dims are
independent runs, each with its own draws.

``aggregate_stacked_consensus`` is ``repro``'s ``shard_map`` wire over the
ranks of a ``torch.distributed`` group, one peer a rank: each round is one
``all_gather`` of every peer's sent vector (``robust_reduce.
all_gather_into``), after which a rank computes its own receiver's f-trim
only, never the ``[n, n, C]`` views of every receiver; a last exchange of
the finals feeds the decision, which every rank computes alike. The leaves
are raveled to f32 in tree order and the wire runs in column blocks of
``robust_reduce.WIRE_CHUNK`` coordinates, every round of a block before
the next block, with one set of round views for all blocks: a rank holds
about ``(2n + k + 3)`` block-sized f32 vectors (the gathered block, the
sort's rows, ``k = stale_rounds`` of straggler history, its own sent,
held and initial values), never ``n x C``. The rounds are coordinate-wise
and every receiver's arithmetic is the emulation's, so the wire equals
the emulation on the gathered stack bit for bit (the tests hold it so).
Fault-free with ``trim="mean"`` and no pins the wire is settled after round
0 (below): one ``all_gather`` and one ``Estimator`` aggregate a block, and
each rank takes in ``n x C x 4`` bytes; every other plan runs ``p_end + 1``
exchanges a block, as ``repro`` does.

Fault-free with ``trim="mean"``, a round is one ``Estimator`` aggregate of
the sent stack (B1 on the card); every peer computes the identical value.
Without pinned rows every row is that value from round 1 on, and the port
does not aggregate the identical rows again: the trimmed aggregate of n
equal values is that value, which VRMOM and the median return bit for bit
(the MAD is 0) and which torch's sequential sum would round for the mean.
The rounds' aux is the same as if they ran, and the output is the direct
aggregate exactly, as ``repro`` states. Under faults the per-receiver
reception masks differ, so rounds run the masked f-trim (sort and a
windowed mean, summed in sorted order, or the midpoint); receivers below
quorum hold their previous value, and quorum loss is reported (the aux
flag), never a NaN.

Adversary model: an attack corrupts the initial stack; passing the
Byzantine mask as ``pin_mask`` makes those rows persistent senders that
re-broadcast their corrupt payload every round.

The round loop runs on the host with ``p_end`` a host int and reads no
device value; ``obs.trace.named_span("consensus.round_loop")`` names it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core.estimator import Estimator
from ..kernels.ref import f32_scalar
from ..obs.trace import named_span
from ..tree import leaves as _leaves, tree_map, unflatten as _unflatten
from .faults import FaultPlan

__all__ = ["ConsensusConfig", "ConsensusAux", "consensus_iterate",
           "consensus_aggregate", "aggregate_stacked_consensus",
           "TRIM_MODES"]

EstimatorLike = Union[str, Estimator]

# Missing-message sentinel: sorts after any real payload but stays a
# normal float (no inf arithmetic near the trim windows), and is far above
# every attack payload in the zoo (|omniscient| ~ 1e10).
_MISSING = 3.0e38

TRIM_MODES = ("mean", "midpoint")


class ConsensusConfig(NamedTuple):
    """Static spec of the consensus iteration.

    ``f``          — Byzantine peers tolerated; drives both the per-round
                     trim width and the ``n - f`` quorum.
    ``eps``        — target agreement diameter.
    ``init_range`` — ``K``: assumed bound on the initial honest spread
                     (enters only through the log in ``p_end``).
    ``trim``       — per-round update: ``"mean"`` (trimmed mean; the
                     Estimator fault-free) or ``"midpoint"`` (JACM86
                     trimmed midpoint).
    ``max_rounds`` — optional hard cap on ``p_end``.
    """
    f: int = 1
    eps: float = 1e-4
    init_range: float = 64.0
    trim: str = "mean"
    max_rounds: Optional[int] = None

    def validate(self, n: int) -> "ConsensusConfig":
        """Approximate consensus under Byzantine peers *and* message loss
        requires ``n > 5f`` (JACM86): an invalid deployment is refused
        before any compute rather than silently losing the guarantee."""
        if self.trim not in TRIM_MODES:
            raise ValueError(
                f"unknown trim mode {self.trim!r}; known: {TRIM_MODES}")
        if self.f < 0:
            raise ValueError(f"f must be >= 0, got {self.f}")
        if n <= 5 * self.f:
            raise ValueError(
                f"consensus validity needs n > 5f: n={n} peers cannot "
                f"tolerate f={self.f} Byzantine faults (need n >= "
                f"{5 * self.f + 1} or f <= {(n - 1) // 5})")
        if not 0.0 < self.eps < self.init_range:
            raise ValueError(
                f"need 0 < eps < init_range, got eps={self.eps}, "
                f"init_range={self.init_range}")
        return self

    def phases(self, plan: Optional[FaultPlan] = None) -> int:
        """Static round bound ``p_end = ceil(log(eps/K)/log(1/2))``.

        Receivers below quorum hold their value instead of updating, so
        with message dropout the bound is doubled; staleness adds its
        window on top. ``max_rounds`` caps the result.
        """
        p = max(1, math.ceil(math.log(self.eps / self.init_range)
                             / math.log(0.5)))
        if plan is not None:
            if plan.dropout > 0.0:
                p *= 2
            if plan.n_stragglers:
                p += int(plan.stale_rounds)
        if self.max_rounds is not None:
            p = min(p, int(self.max_rounds))
        return p


class ConsensusAux(NamedTuple):
    """What one consensus aggregate reports: 0-d tensors on the stack's
    device, or ``[...]`` for a stack with leading dims."""
    rounds_run: torch.Tensor        # int32 — static phase bound executed
    rounds_to_eps: torch.Tensor     # int32 — first round with honest
    #                                 spread <= eps (rounds_run if never)
    spread: torch.Tensor            # f32 — final honest-alive spread
    quorum: torch.Tensor            # f32 — fraction of (round, alive
    #                                 receiver) slots meeting n-f quorum
    quorum_lost: torch.Tensor       # bool — no alive receiver met quorum
    #                                 in the final round
    messages_dropped: torch.Tensor  # int32 — alive->alive messages lost


# ---------------------------------------------------------------------------
# round primitives
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _network(n: int):
    """Batcher's odd-even merge sort on ``n`` keys: the compare-exchange
    pairs ``(lo, hi)`` in order (the power-of-two network with the pairs
    that reach past ``n`` left out, which sorts any ``n``)."""
    pairs, p = [], 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def _sorted_rows(vals, recv):
    """The rows of ``where(recv, vals, _MISSING)`` (``vals`` [..., n, C],
    ``recv`` [..., n]) sorted coordinate by coordinate, as a list of n
    ``[..., C]`` tensors, smallest first: the values a sort along ``n``
    gives, NaN last (so a NaN payload is trimmed like any outlier), by a
    compare-exchange network (no index tensor; each step reads two
    rows): ``fmin`` keeps the number of a (number, NaN) pair low and
    ``maximum`` the NaN high."""
    rows = [torch.where(recv[..., j, None], vals[..., j, :], _MISSING)
            for j in range(vals.shape[-2])]
    for i, j in _network(len(rows)):
        a, b = rows[i], rows[j]
        rows[i], rows[j] = torch.fmin(a, b), torch.maximum(a, b)
    return rows


def _masked_trim(vals, recv, f: int, trim: str):
    """f-trimmed aggregate of the received subset of ``vals``.

    ``vals`` [..., n, C]; ``recv`` [..., n] bool (leading dims broadcast:
    a receiver axis before ``n`` gives every receiver's view). Missing
    rows become the ``_MISSING`` sentinel and sort to the top, so the trim
    window ``[f, n_recv - f)`` only ever touches real payloads. Returns
    [..., C], always finite (an empty window gives 0; callers gate on
    quorum before trusting the value). The mean sums the window in sorted
    order.
    """
    n = vals.shape[-2]
    srt = _sorted_rows(vals, recv)
    n_recv = recv.sum(-1)
    if trim == "midpoint":
        lo_i = torch.clamp(torch.clamp(n_recv - 1, min=0), max=f)
        hi_i = torch.clamp(torch.maximum(n_recv - 1 - f, lo_i), max=n - 1)
        stacked = torch.stack(srt, dim=-2)
        shape = stacked.shape[:-2] + (1, stacked.shape[-1])

        def pick(i):
            return torch.gather(stacked, -2, i[..., None, None].expand(shape)
                                ).squeeze(-2)

        return torch.where(n_recv[..., None] > 0,
                           0.5 * (pick(lo_i) + pick(hi_i)), 0.0)
    # the window [f, n_recv - f) lies inside [f, n - f): the rows outside
    # that add nothing
    last = (n_recv - f)[..., None]
    acc = torch.zeros_like(srt[0])
    for i in range(f, n - f):
        acc = acc + torch.where(i < last, srt[i], 0.0)
    denom = torch.clamp(n_recv - 2 * f, min=1).float()
    return acc / denom[..., None]


def _spread(vals, mask):
    """[...] f32 — max over coordinates of (max - min) over the ``mask``
    rows of ``vals`` [..., n, C]; 0 when fewer than two rows are
    selected."""
    m = mask[..., None]
    hi = torch.amax(torch.where(m, vals, -_MISSING), dim=-2)
    lo = torch.amin(torch.where(m, vals, _MISSING), dim=-2)
    sp = torch.amax(hi - lo, dim=-1)
    return torch.where(mask.sum(-1) >= 2, sp, 0.0)


def _rounds_to_eps(spreads, final_spread, eps: float, p_end: int):
    """First round index whose *entering* honest spread is <= eps
    (``spreads[..., p]`` is measured on the values entering round p, so
    index p means "converged after p rounds"); ``p_end`` if only the final
    values, or nothing, made it."""
    conv = torch.cat([spreads, final_spread[..., None]], dim=-1) <= eps
    first = torch.argmax(conv.to(torch.int32), dim=-1)
    return torch.where(conv.any(-1), first, p_end).to(torch.int32)


class _RoundViews(NamedTuple):
    """The fault state of every round of a run, from the plan and the
    draws alone (so one set serves every column block of a wire)."""
    recv: torch.Tensor     # [..., P, n, n] bool — recv[p, i, j]: i got j
    alive: torch.Tensor    # [P, n] bool
    q_ok: torch.Tensor     # [..., P, n] bool — receiver met the quorum
    dropped: torch.Tensor  # [..., P] int32 — alive->alive messages lost


def _round_views(plan: FaultPlan, n: int, p_end: int, quorum: int, *,
                 batch=(), draws=None, generator=None,
                 device=None) -> _RoundViews:
    recv = plan.recv_matrices(n, p_end, batch=batch, draws=draws,
                              generator=generator, device=device)
    p = torch.arange(p_end, device=device)[:, None]
    alive = ~(plan.crashed_mask(n, device)[None] & (p >= plan.crash_round))
    q_ok = recv.sum(-1) >= quorum
    eye = torch.eye(n, dtype=torch.bool, device=device)
    expected = alive[:, :, None] & alive[:, None, :] & ~eye
    dropped = torch.sum(expected & ~recv, dim=(-2, -1), dtype=torch.int32)
    return _RoundViews(recv, alive, q_ok, dropped)


def _prep(n: int, est: EstimatorLike, config, plan):
    """Argument normalization and validation, before any compute."""
    est = Estimator.coerce(est).require_coordinatewise(
        "consensus rounds (dist.consensus)")
    config = config if config is not None else ConsensusConfig()
    if not isinstance(config, ConsensusConfig):
        raise TypeError(f"expected ConsensusConfig, got {type(config)!r}")
    config.validate(n)
    plan = (plan if plan is not None else FaultPlan()).validate(n)
    return est, config, plan


def _pin(pin_mask, n: int, device):
    if pin_mask is None:
        return None
    pin = torch.as_tensor(pin_mask, device=device).to(torch.bool)
    if tuple(pin.shape) != (n,):
        raise ValueError(f"pin_mask of shape {tuple(pin.shape)}; the stack "
                         f"has {n} peers")
    return pin


def _iterate(v0, est: Estimator, config: ConsensusConfig, plan: FaultPlan,
             views: _RoundViews, pin):
    """The value loop on an f32 stack ``v0`` [..., n, C]: (finals [..., n,
    C] with pinned rows at ``v0`` (fault-free and unpinned: one row
    broadcast to every peer), spreads [..., P] of the honest alive rows of
    each round's sent stack)."""
    n = v0.shape[-2]
    p_end = views.alive.shape[0]
    f, trim = config.f, config.trim
    k = int(plan.stale_rounds) if plan.n_stragglers else 0
    strag = plan.straggler_mask(n, v0.device)[:, None]
    pin_c = None if pin is None else pin[:, None]
    fault_free = plan.trivial and trim == "mean"
    # every row holds the same value from round 1 on (module docstring)
    settled = fault_free and pin is None
    hist = [v0] * k
    v = v0
    spreads = []
    for p in range(p_end):
        if settled and p > 1:
            spreads.append(spreads[1])
            continue
        sent = torch.where(strag, hist[k - 1], v) if k else v
        if pin is not None:
            sent = torch.where(pin_c, v0, sent)
        alive = views.alive[p]
        honest = alive if pin is None else alive & ~pin
        spreads.append(_spread(sent, honest))
        if settled and p == 1:
            continue
        if fault_free:  # every peer receives all and updates
            v = est.apply(sent, axis=sent.ndim - 2).unsqueeze(-2).expand(
                v0.shape)
        else:
            new = _masked_trim(sent.unsqueeze(-3), views.recv[..., p, :, :],
                               f, trim)
            v = torch.where((views.q_ok[..., p, :] & alive)[..., None], new,
                            v)
        if k:
            hist = [v] + hist[:k - 1]
    if pin is not None:
        v = torch.where(pin_c, v0, v)
    return v, torch.stack(spreads, dim=-1)


def _aux(views: _RoundViews, spreads, final_spread, eps: float,
         batch) -> ConsensusAux:
    """The aux of a run from its round views and its honest spreads."""
    p_end = views.alive.shape[0]
    live = views.q_ok & views.alive
    n_alive = torch.clamp(views.alive.sum(-1), min=1).float()
    share = live.sum(-1).float() / n_alive
    q_sum = torch.zeros_like(share[..., 0])
    for p in range(p_end):  # f32, in round order, as repro accumulates
        q_sum = q_sum + share[..., p]
    dev = spreads.device

    def full(x):
        return torch.broadcast_to(x, batch)

    return ConsensusAux(
        rounds_run=full(torch.tensor(p_end, dtype=torch.int32, device=dev)),
        rounds_to_eps=_rounds_to_eps(spreads, final_spread, eps, p_end),
        spread=final_spread,
        quorum=full(q_sum / f32_scalar(p_end, dev)),
        quorum_lost=full(~live[..., p_end - 1, :].any(-1)),
        messages_dropped=full(views.dropped.sum(-1, dtype=torch.int32)))


def _run(stack, est, config, plan, generator, draws, pin_mask):
    """(config, plan, finals, pinned, aux) of one emulated run."""
    n = stack.shape[-2]
    est, config, plan = _prep(n, est, config, plan)
    dev = stack.device
    batch = tuple(stack.shape[:-2])
    p_end = config.phases(plan)
    views = _round_views(plan, n, p_end, n - config.f, batch=batch,
                         draws=draws, generator=generator, device=dev)
    pin = _pin(pin_mask, n, dev)
    v0 = stack.float()
    with named_span("consensus.round_loop"):
        finals, spreads = _iterate(v0, est, config, plan, views, pin)
    honest_end = _honest_end(plan, n, p_end, pin, dev)
    aux = _aux(views, spreads, _spread(finals, honest_end), config.eps,
               batch)
    return config, plan, finals, pin is not None, aux


def _alive_end(plan: FaultPlan, n: int, p_end: int, device):
    return ~plan.crashed_at(n, p_end, device)


def _honest_end(plan, n, p_end, pin, device):
    alive = _alive_end(plan, n, p_end, device)
    return alive if pin is None else alive & ~pin


def _decide(finals, config: ConsensusConfig, plan: FaultPlan, pinned: bool):
    """The decision on the finals [..., n, C] -> [..., C]: the f-trimmed
    aggregate over the still-alive peers' final values; fault-free with
    the mean trim and no pins every final row is the same Estimator
    output, which is returned as it is."""
    if plan.trivial and config.trim == "mean" and not pinned:
        return finals[..., 0, :]
    alive = _alive_end(plan, finals.shape[-2], config.phases(plan),
                       finals.device)
    return _masked_trim(finals, alive, config.f, config.trim)


def consensus_iterate(stack, est: EstimatorLike = "vrmom", *,
                      config: Optional[ConsensusConfig] = None,
                      plan: Optional[FaultPlan] = None, generator=None,
                      draws=None, pin_mask=None
                      ) -> Tuple[torch.Tensor, ConsensusAux]:
    """Run the full consensus iteration on a local ``[..., n, C]`` stack.

    Returns ``(finals, aux)``: ``finals`` [..., n, C] f32 holds every
    peer's value after ``p_end`` rounds. ``pin_mask`` [n] bool marks
    persistent Byzantine senders (they re-broadcast their initial, already
    attack-corrupted, row every round and never update). ``generator`` (a
    ``torch.Generator`` on the stack's device) draws the dropout of every
    round and leading index at once; ``draws`` [..., p_end, n, n] hands
    the uniforms in instead (``FaultPlan.recv_matrices``).
    """
    _, _, finals, _, aux = _run(stack, est, config, plan, generator, draws,
                                pin_mask)
    # fault-free, the finals may be one row broadcast to every peer
    return finals.contiguous(), aux


def consensus_aggregate(stack, est: EstimatorLike = "vrmom", *,
                        config: Optional[ConsensusConfig] = None,
                        plan: Optional[FaultPlan] = None, generator=None,
                        draws=None, pin_mask=None
                        ) -> Tuple[torch.Tensor, ConsensusAux]:
    """``[..., n, C] -> ([..., C] f32, ConsensusAux)``: iterate, then
    decide (:func:`_decide`). Robust to up to ``f`` persistent Byzantine
    rows, finite (never NaN) even below quorum. Fault-free with
    ``trim="mean"`` and no pins the result is the direct Estimator
    aggregate exactly."""
    config, plan, finals, pinned, aux = _run(stack, est, config, plan,
                                             generator, draws, pin_mask)
    return _decide(finals, config, plan, pinned), aux


# ---------------------------------------------------------------------------
# the wire over the ranks of a process group
# ---------------------------------------------------------------------------

def aggregate_stacked_consensus(grads, group=None,
                                est: EstimatorLike = "vrmom", *,
                                config: Optional[ConsensusConfig] = None,
                                plan: Optional[FaultPlan] = None,
                                generator=None, draws=None, pin_mask=None,
                                attack=None, with_diag: bool = False):
    """Peer-to-peer consensus aggregate of a stacked tree over the ranks of
    ``group``, one peer a rank (module docstring): ``(tree,
    ConsensusAux)``, with ``with_diag`` ``(tree, ConsensusAux,
    obs.diag.AggDiagnostics)``, the tree's leaves in their dtypes and tree
    and aux the same on every rank.

    ``grads``: this rank's leaves ``[1, ...]``, the same tree on every rank;
    rank r is peer r, so n is the world size. ``generator`` (the same state
    on every rank, so every rank builds the same reception matrices) draws
    the dropout, or ``draws`` ``[p_end, n, n]`` hands the uniforms in;
    ``pin_mask`` [n] marks persistent Byzantine senders. ``attack``: a
    callable ``[n, ...] -> [n, ...]`` with its mask and generator bound. It
    is applied to round 0's gathered stack leaf by leaf, in each leaf's
    dtype and shape, so it computes what the one-process step's attack on
    each leaf's stack does and draws from the generator before the rounds
    do; each rank then keeps its own corrupted row as its initial value.
    With an attack the rank holds the attacked ``[n, C]`` f32 stack, as
    ``repro``'s wire does (ROADMAP.md §C); without one, a block at a time.

    Refused before any collective: a rank holding other than one row
    (``robust_reduce.GroupRefusal``), and what one process refuses (a
    whole-vector estimator, ``n <= 5f``, a bad plan: ``ValueError``).
    Without a group, or on one rank, this is the one-process emulation with
    f = 0 (a single peer has nothing to disagree about), as in ``repro``,
    the attack applied leaf by leaf."""
    from . import robust_reduce as RR

    nw = RR.group_world(group)
    if nw <= 1:
        cfg = config if config is not None else ConsensusConfig()
        if isinstance(cfg, ConsensusConfig):
            cfg = cfg._replace(f=0)
        if attack is not None:
            grads = tree_map(attack, grads)
        return RR.aggregate_stacked_auto(
            grads, est, with_diag=with_diag, reduce_backend="consensus",
            consensus=cfg, plan=plan, generator=generator, draws=draws,
            pin_mask=pin_mask)
    import torch.distributed as dist

    leaves = list(_leaves(grads))
    est, config, plan = _prep(nw, est, config, plan)
    rows = sorted({g.shape[0] for g in leaves})
    if rows != [1]:
        raise RR.GroupRefusal(
            f"consensus wire: a rank holds {rows} worker rows; the worker "
            f"dim must be fully sharded over the group's {nw} ranks (one "
            f"worker a rank)")
    rank, dev = dist.get_rank(group), leaves[0].device
    sizes = [g[0].numel() for g in leaves]
    f32 = dict(dtype=torch.float32, device=dev)

    def exchange(sent):
        allv = torch.empty((nw, sent.numel()), **f32)
        RR.all_gather_into(allv.view(-1), sent.contiguous(), group)
        return allv

    stack = None
    if attack is not None:
        with named_span("consensus.attack"):
            stack = exchange(torch.cat([g.reshape(-1).float()
                                        for g in leaves]))
            off = 0
            for g, n in zip(leaves, sizes):
                seg = stack[:, off:off + n]
                hit = attack(seg.to(g.dtype).contiguous().reshape(
                    (nw,) + tuple(g.shape[1:])))
                seg.copy_(hit.reshape(nw, n))
                off += n
    p_end = config.phases(plan)
    views = _round_views(plan, nw, p_end, nw - config.f, draws=draws,
                         generator=generator, device=dev)
    pin = _pin(pin_mask, nw, dev)
    honest_end = _honest_end(plan, nw, p_end, pin, dev)
    outs = [torch.empty(g.shape[1:], dtype=g.dtype, device=dev)
            for g in leaves]
    moments = None
    if with_diag:
        from ..obs import diag as OD

        moments = OD._zeros(nw, dev)
    spreads = final = None
    chunk, C = RR.WIRE_CHUNK, sum(sizes)
    with named_span("consensus.round_loop"):
        for lo in range(0, C, chunk):
            hi = min(lo + chunk, C)
            pieces = list(RR._pieces(sizes, lo, hi, chunk))
            if stack is None:
                v0, first = torch.empty(hi - lo, **f32), None
                for a, e, i, col in pieces:
                    v0[a - lo:e - lo] = leaves[i].reshape(-1)[col:col + e - a]
            else:
                first = stack[:, lo:hi]
                v0 = first[rank]
            dec, sp, fs, first = _rank_rounds(
                v0, first, exchange, est, config, plan, views, pin,
                honest_end, rank, keep_first=with_diag)
            spreads = sp if spreads is None else torch.maximum(spreads, sp)
            final = fs if final is None else torch.maximum(final, fs)
            for a, e, i, col in pieces:
                outs[i].view(-1)[col:col + e - a] = dec[a - lo:e - lo]
            if moments is not None:
                # the moments of the leaves as they come back: each piece's
                # decision rounded to its leaf's dtype
                held = dec.clone()
                for a, e, i, _ in pieces:
                    held[a - lo:e - lo] = held[a - lo:e - lo].to(
                        leaves[i].dtype).float()
                OD._add_moments(moments, first, held)
    out = _unflatten(grads, outs)
    aux = _aux(views, spreads, final, config.eps, ())
    if with_diag:
        return out, aux, OD.finalize_diag(*moments)
    return out, aux


def _rank_rounds(v0, first, exchange, est: Estimator,
                 config: ConsensusConfig, plan: FaultPlan,
                 views: _RoundViews, pin, honest_end, rank: int, *,
                 keep_first: bool):
    """One column block on this rank: ``_iterate`` and ``_decide`` for its
    own receiver, on ``v0`` [c] f32 (its initial value), ``exchange``
    gathering every peer's sent vector [c] into [n, c]. ``first``: round
    0's gathered stack when the caller holds it already (the attack's
    gather), else None. Returns (decision [c], spreads [P], final spread,
    round 0's gathered stack if ``keep_first`` else None)."""
    n, p_end = views.alive.shape[1], views.alive.shape[0]
    f, trim = config.f, config.trim
    k = int(plan.stale_rounds) if plan.n_stragglers else 0
    straggler = plan.n_crashed <= rank < plan.n_crashed + plan.n_stragglers
    mine = None if pin is None else pin[rank]
    fault_free = plan.trivial and trim == "mean"
    # every row holds round 0's aggregate from round 1 on (module
    # docstring): nothing more to exchange or aggregate
    settled = fault_free and pin is None
    hist = [v0] * k
    v = v0
    spreads, kept = [], None
    for p in range(p_end):
        alive = views.alive[p]
        honest = alive if pin is None else alive & ~pin
        if settled and p > 1:
            spreads.append(spreads[1])
            continue
        if settled and p == 1:
            spreads.append(_spread(v.expand(n, -1), honest))
            continue
        sent = hist[k - 1] if straggler else v
        if mine is not None:
            sent = torch.where(mine, v0, sent)
        allv = first if p == 0 and first is not None else exchange(sent)
        if p == 0 and keep_first:
            kept = allv
        spreads.append(_spread(allv, honest))
        if fault_free:  # every peer receives all and updates
            v = est.apply(allv, axis=0)
        else:
            new = _masked_trim(allv, views.recv[p, rank], f, trim)
            v = torch.where(views.q_ok[p, rank] & alive[rank], new, v)
        del allv
        if k:
            hist = [v] + hist[:k - 1]
    if mine is not None:
        v = torch.where(mine, v0, v)
    if settled:
        finals, dec = v.expand(n, -1), v
    else:
        finals = exchange(v)
        dec = _decide(finals, config, plan, pin is not None)
    return dec, torch.stack(spreads), _spread(finals, honest_end), kept
