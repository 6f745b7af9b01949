"""Monte-Carlo coverage harness for the plug-in CIs, the port of
``repro.infer.coverage``.

Reproduces the statistical side of the paper's Section 4: for a (model,
attack, Byzantine fraction, aggregator) cell, run ``reps`` full
replications — simulate sharded data, run RCSL under attack, compute
plug-in CIs under the *same* attack on the reported statistics
(``infer.sandwich``), and record whether each coordinate of theta* landed
inside its interval — then report empirical coverage, mean CI width and
RMSE.

The replications run ``batch_size`` at a time as tensors with a leading
replication axis: one chunk's data is ``[batch_size, m+1, n, p]``, and
each coordinate-wise aggregation of the chunk is one ``[m+1,
batch_size·d]`` stack (B1 on the card). An adaptive estimator
(``vrmom_adaptive``, ``auto_gm``) censuses each replication's rows on its
own, as ``repro``'s map over replications does, and runs its B1 launches
over the whole chunk. One ``torch.Generator``, seeded
with ``seed``, draws the chunks' data and attacks in order, so two cells
with the same seed and shapes see the same shards and attack draws.

Over the ranks of a ``torch.distributed`` group (``group=``, where
``repro`` takes a mesh and a replication axis), rank r runs replications
``[r·reps/P, (r+1)·reps/P)`` as a one-process cell of ``reps/P``
replications seeded :func:`rank_seed` ``(seed, r)``, and one
``all_gather`` of the packed results hands every rank the whole cell in
rank order. A generator draws a chunk's replications at once, so which
replications share a chunk changes the draws (``repro`` draws a key a
replication, and its split does not): the group cell equals the
concatenation of those P one-process cells bit for bit, not the
one-process cell of ``reps`` replications.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..core import rcsl as R
from ..core.estimator import Estimator
from ..device import resolve_device
from ..dist.robust_reduce import all_gather_into, group_world
from .sandwich import infer

__all__ = ["CoverageCell", "coverage_run", "rank_seed"]

# apart from the consensus stream's offset of 2**32, so that for seeds in
# [0, 2**31) no two ranks' streams, nor a rank's two, share a seed
RANK_STRIDE = 1 << 33


class CoverageCell(NamedTuple):
    """Raw per-replication outcomes of one coverage cell.

    covered: ``[reps, p]`` bool — theta*_l inside [lower_l, upper_l].
    width:   ``[reps, p]`` CI widths.
    err:     ``[reps, p]`` estimation errors theta_hat - theta*.
    """

    covered: torch.Tensor
    width: torch.Tensor
    err: torch.Tensor

    def summary(self) -> dict:
        """Host-side scalars for tables."""
        return {
            "coverage": float(self.covered.float().mean()),
            "coverage_per_coord": [float(c) for c in
                                   self.covered.float().mean(dim=0)],
            "mean_width": float(self.width.mean()),
            "rmse": float(torch.sqrt(torch.mean(self.err ** 2))),
            "reps": int(self.covered.shape[0]),
        }


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s replications in a cell seeded ``seed``
    over a group: ``seed + rank * 2**33``. Its data and attack stream is
    seeded with it and its consensus stream with it plus ``2**32``, as a
    one-process cell seeded with it is; rank 0 keeps ``seed`` and ``seed +
    2**32``. For ``0 <= seed < 2**31`` the streams of every rank (below
    2**30 ranks) are seeded apart."""
    return seed + rank * RANK_STRIDE


def coverage_run(
    model: str = "linear",
    attack: str = "gaussian",
    alpha: float = 0.1,
    estimator: Union[str, Estimator] = "vrmom",
    K: int = 10,
    level: float = 0.95,
    reps: int = 200,
    N_per_machine: int = 200,
    m_workers: int = 100,
    p: int = 5,
    rounds: int = 6,
    mu_x: float = 0.0,
    labelflip: bool = False,
    simultaneous: bool = False,
    seed: int = 0,
    batch_size: int = 16,
    device=None,
    reduce_backend: str = "direct",
    consensus=None,
    fault_plan=None,
    assumed_alpha: Optional[float] = None,
    group=None,
) -> CoverageCell:
    """Run one coverage cell; see the module docstring.

    ``device=None`` is the card (it raises where there is none);
    ``device="cpu"`` runs the plain path on the host. ``assumed_alpha``:
    the contamination the analyst plugs into the CI inflation, apart from
    the true ``alpha`` (``infer``'s knob; ``None`` assumes the truth).
    ``reduce_backend="consensus"`` runs every RCSL round's aggregation
    through the peer-to-peer consensus emulation (``dist.consensus``)
    under ``consensus`` (a ``ConsensusConfig``) and ``fault_plan`` (a
    ``FaultPlan``), a chunk's replications in one call, each with its own
    dropout, drawn from a generator of their own seeded from ``seed``.

    ``group``: a ``torch.distributed`` process group over whose P ranks
    the replications split (module docstring); every rank calls with the
    same arguments and returns the same whole cell. ``reps`` must be
    divisible by P (``ValueError`` on every rank before any collective),
    and every rank must resolve ``device`` to the same kind of device
    (``ValueError`` on every rank otherwise). ``None`` or one rank is the
    one-process cell.
    """
    world = group_world(group)
    if world > 1:
        if reps % world:
            raise ValueError(f"reps={reps} not divisible by the {world} "
                             f"ranks of the group")
        return _group_cell(group, reps // world, seed, device, dict(
            model=model, attack=attack, alpha=alpha, estimator=estimator,
            K=K, level=level, N_per_machine=N_per_machine,
            m_workers=m_workers, p=p, rounds=rounds, mu_x=mu_x,
            labelflip=labelflip, simultaneous=simultaneous,
            batch_size=batch_size, reduce_backend=reduce_backend,
            consensus=consensus, fault_plan=fault_plan,
            assumed_alpha=assumed_alpha))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # the consensus rounds' draws: a stream apart from the data and attacks
    fault_gen = torch.Generator(device=dev).manual_seed(seed + (1 << 32))
    theta_star = R.paper_theta_star(p, device=dev)
    problem = (R.LinearRegressionProblem() if model == "linear"
               else R.LogisticRegressionProblem())
    covered, width, err = [], [], []
    for start in range(0, reps, batch_size):
        b = min(batch_size, reps - start)
        shards = R.make_shards(gen, N_per_machine=N_per_machine,
                               m_workers=m_workers, p=p,
                               theta_star=theta_star, model=model,
                               mu_x=mu_x, reps=b, device=dev)
        theta_hat, _ = R.rcsl(problem, shards, gen, alpha=alpha,
                              attack=attack, aggregator=estimator, K=K,
                              rounds=rounds, labelflip=labelflip,
                              reduce_backend=reduce_backend,
                              consensus=consensus, fault_plan=fault_plan,
                              fault_generator=fault_gen)
        shards_rep, stat_attack = shards, attack
        if labelflip:
            # Label-flip Byzantine machines report *honest* statistics
            # computed on flipped-label data (paper 4.2.2): flip their
            # shard labels before machine_stats, and layer no registry
            # attack on top.
            mask = R.attacks.byzantine_mask(m_workers + 1, alpha, device=dev)
            shards_rep = R.Shards(
                X=shards.X,
                Y=torch.where(mask[:, None], 1.0 - shards.Y, shards.Y))
            stat_attack = "none"
        res = infer(problem, shards_rep, theta_hat, estimator=estimator, K=K,
                    level=level, simultaneous=simultaneous, alpha=alpha,
                    attack=stat_attack, generator=gen,
                    assumed_alpha=assumed_alpha)
        del shards, shards_rep  # free the chunk before the next is drawn
        covered.append((res.ci.lower <= theta_star)
                       & (theta_star <= res.ci.upper))
        width.append(res.ci.upper - res.ci.lower)
        err.append(theta_hat - theta_star)
    return CoverageCell(covered=torch.cat(covered), width=torch.cat(width),
                        err=torch.cat(err))


def _group_cell(group, reps: int, seed: int, device, kw: dict
                ) -> CoverageCell:
    """This rank's ``reps`` replications seeded ``rank_seed(seed, rank)``,
    then every rank's gathered in rank order: ``covered``, ``width`` and
    ``err`` packed as one ``[reps, 3p]`` tensor of ``width``'s dtype
    (covered as 0 / 1), one ``all_gather``."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = resolve_device(device)
    kinds = [None] * world
    dist.all_gather_object(kinds, dev.type, group=group)
    if len(set(kinds)) > 1:
        raise ValueError(f"the ranks of the group resolve device={device!r} "
                         f"to {kinds}: a group cell runs on one kind of "
                         f"device")
    cell = coverage_run(reps=reps, seed=rank_seed(seed, rank), device=dev,
                        **kw)
    p = cell.width.shape[1]
    packed = torch.cat([cell.covered.to(cell.width.dtype), cell.width,
                        cell.err.to(cell.width.dtype)], dim=1).contiguous()
    out = torch.empty((world * reps, 3 * p), dtype=packed.dtype, device=dev)
    all_gather_into(out.view(-1), packed.view(-1), group)
    return CoverageCell(covered=out[:, :p] != 0, width=out[:, p:2 * p],
                        err=out[:, 2 * p:])
