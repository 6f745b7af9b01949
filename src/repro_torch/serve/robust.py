"""Byzantine-robust replicated decoding (``repro.serve.robust``'s port).

The decode forward runs on ``m`` replicas; each emits logits for the same
positions, and the served logits are the robust aggregate (an
``core.estimator.Estimator``: VRMOM / median / trimmed mean, or the
adaptive ``vrmom_adaptive`` / ``auto_gm``, whose census treats the
``[m, B, V]`` stack as m rows of B·V coordinates) over the replica axis. While fewer than half the replicas are corrupted, the
aggregate — and every greedy token — is unchanged: honest replicas are
deterministic, so their rows are identical, the median of the stack is the
honest value, and VRMOM's degenerate-scale guard returns exactly that
median. The ``[m, B, V]`` stack goes through the fused CUDA tail (B4) or
the aggregation kernel (B1) once per token; an adaptive estimator takes
the unfused tail (one B1 launch for the census centre and one for each
VRMOM rung, or Weiszfeld's iterations), with nothing read on the host, so
the engine's captured decode step replays it.

``core/attacks`` fault injection corrupts the rows ``replica_mask``
selects before aggregation, modelling faulty workers on the wire.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..core import attacks as ATK
from ..core.estimator import Estimator
from ..lint.hashguard import check_hashable_fields
from ..models import model as M
from ..models.attention import row_pos
from ..models.caches import map_rows, row_fields

__all__ = ["RobustDecodeConfig", "replica_mask", "stack_replicas",
           "flatten_replicas", "unflatten_replicas", "robust_logits",
           "robust_sample", "robust_decode_step"]


@dataclasses.dataclass(frozen=True)
class RobustDecodeConfig:
    """Config for replicated robust decode.

    m:          number of decode replicas (worker-axis size).
    estimator:  a coordinate-wise or adaptive ``Estimator`` or a method
                name (coerced: ``K`` binds to VRMOM, and trimmed_mean's
                beta binds to ``alpha`` — the default 0.1 would trim
                int(0.1*m) = 0 rows at m = 8 and silently serve the mean).
                Whole-vector selectors (geometric_median, krum) are
                refused.
    K:          VRMOM quantile levels (used when coercing a name).
    attack:     ``core/attacks`` name injected on the corrupted rows
                ("none" in production).
    alpha:      corrupted fraction; floor(alpha * m) rows are attacked.
    share_replica_compute:
                ``True`` runs the forward once and broadcasts its logits
                into the [m, B, V] stack — token-identical to running every
                replica, since honest replicas are the same deterministic
                function of the same state. ``False`` runs all m replica
                forwards as one decode step at batch m * B (replica-major
                rows), the emulation the equivalence is tested against.
    fuse_tail:  aggregate and sample in ONE kernel (B4) for greedy / top-k
                (coordinate-wise methods); ``False`` aggregates with B1,
                then selects in PyTorch. Greedy tokens are bit-identical
                either way.

    The spec is validated against ``m`` at construction.
    """

    m: int = 8
    estimator: Union[str, Estimator] = "vrmom"
    K: int = 8
    attack: str = "none"
    alpha: float = 0.25
    fuse_tail: bool = True
    share_replica_compute: bool = True

    def __post_init__(self):
        est = self.estimator
        if isinstance(est, str):
            est = Estimator(method=est)
            if est.method == "vrmom":
                est = est._replace(K=self.K)
            if est.method == "trimmed_mean":
                est = est._replace(beta=self.alpha)
        elif not isinstance(est, Estimator):
            raise TypeError(
                f"estimator must be a method name or an Estimator, "
                f"got {type(est)!r}")
        est.require_stackable("replicated logit aggregation (serve.robust)")
        est.validate(self.m)
        object.__setattr__(self, "estimator", est)
        # the config keys the engine's captured steps: an unhashable field
        # fails here, naming the field (reprolint RL004), before the
        # attack lookup would hash it and raise a bare TypeError
        check_hashable_fields(self)
        if self.attack not in ATK.REGISTRY:
            raise ValueError(f"unknown attack {self.attack!r}; known: "
                             f"{sorted(ATK.REGISTRY)}")


def replica_mask(m: int, alpha: float, device=None) -> torch.Tensor:
    """[m] bool — the last floor(alpha*m) replicas are corrupted. Built on
    ``device`` directly (no host-to-device copy in the decode loop)."""
    n_byz = int(math.floor(alpha * m))
    if n_byz >= (m + 1) // 2:
        raise ValueError(f"alpha={alpha} corrupts {n_byz}/{m}: no honest "
                         "majority, aggregation cannot be robust")
    return torch.arange(m, device=device) >= m - n_byz


def stack_replicas(caches, m: int):
    """Stacked caches [L, B, ...] (any cache type) -> a leading replica dim
    [m, L, B, ...] (broadcast views); ``pos`` [B] becomes [m, B] (a scalar
    broadcasts to every row first)."""
    first = getattr(caches, row_fields(caches)[0])
    pos = row_pos(caches.pos, first.shape[1], first.device)
    return map_rows(caches, lambda x: x[None].expand((m,) + x.shape)
                    )._replace(pos=pos[None].expand(m, pos.shape[0]))


def flatten_replicas(rep, m: int):
    """[m, L, B, ...] -> [L, m * B, ...], replica-major: row r * B + b is
    replica r of sequence b. Every cache leaf has its batch dim at 1;
    ``pos`` [m, B] becomes [m * B], so each flat row keeps its length.
    Replicas that share memory (``stack_replicas``' broadcast) are copied
    apart, as decode writes each row in place."""
    def one(x):
        x = x.movedim(0, 1)
        return x.reshape((x.shape[0], m * x.shape[2]) + x.shape[3:]
                         ).contiguous()

    return map_rows(rep, one)._replace(pos=rep.pos.reshape(-1).contiguous())


def unflatten_replicas(flat, m: int):
    """Inverse of :func:`flatten_replicas` (``pos`` [m * B] -> [m, B])."""
    def one(x):
        x = x.reshape((x.shape[0], m, x.shape[1] // m) + x.shape[2:])
        return x.movedim(1, 0)

    return map_rows(flat, one)._replace(pos=flat.pos.reshape(m, -1))


def _attack(logits_r, rcfg: RobustDecodeConfig, generator):
    if rcfg.attack == "none":
        return logits_r
    mask = replica_mask(rcfg.m, rcfg.alpha, device=logits_r.device)
    return ATK.get(rcfg.attack)(generator, logits_r, mask)


def robust_logits(logits_r, rcfg: RobustDecodeConfig,
                  generator: Optional[torch.Generator] = None, *,
                  with_diag: bool = False):
    """Corrupt the attacked rows, then robustly aggregate.
    logits_r: [m, B, V]. Returns [B, V] f32 aggregated logits; with
    ``with_diag`` also the per-token replica-disagreement rate [B] f32
    (``obs.diag.replica_disagreement`` of the attacked stack): the
    fraction of replicas whose argmax differs from the served token."""
    x = _attack(logits_r, rcfg, generator)
    agg = rcfg.estimator.apply(x.float(), axis=0)
    if with_diag:
        from ..obs.diag import replica_disagreement

        return agg, replica_disagreement(x, agg)
    return agg


def robust_sample(logits_r, rcfg: RobustDecodeConfig,
                  generator: Optional[torch.Generator], sc, *,
                  with_diag: bool = False):
    """The whole robust-decode tail: attack, aggregate, sample -> tok [B]
    int32 (and with ``with_diag`` the replica-disagreement rate [B] f32 of
    the attacked stack). ``generator`` feeds the attack noise and the
    sampling draw; the diagnostic draws nothing.

    With ``rcfg.fuse_tail`` and greedy / top-k sampling this is one fused
    kernel (B4), which writes the [B, V] aggregate only when the
    diagnostic reads it (``with_agg``); greedy tokens are bit-identical to
    ``sample_tokens(robust_logits(...))`` either way, and top-k draws over
    B4's [B, k] (value, index) lists, the masked-vocab distribution.
    Temperature-only sampling needs the whole [B, V] aggregate and takes
    the unfused tail.
    """
    from .engine import categorical, sample_tokens

    if not (rcfg.fuse_tail and sc.method in ("greedy", "top_k")):
        out = robust_logits(logits_r, rcfg, generator, with_diag=with_diag)
        agg, dis = out if with_diag else (out, None)
        tok = sample_tokens(agg, generator, sc)
        return (tok, dis) if with_diag else tok
    x = _attack(logits_r, rcfg, generator).float().contiguous()
    if sc.method == "greedy":
        agg, tok = rcfg.estimator.apply_sample(x, with_agg=with_diag)
    else:
        if sc.top_k <= 0:
            raise ValueError("top_k sampling needs top_k > 0")
        agg, topv, topi = rcfg.estimator.apply_sample(x, top_k=sc.top_k,
                                                      with_agg=with_diag)
        idx = categorical(topv / max(sc.temperature, 1e-6), generator)
        tok = torch.gather(topi, 1, idx[:, None].long())[:, 0]
    if with_diag:
        from ..obs.diag import replica_disagreement

        return tok, replica_disagreement(x, agg)
    return tok


def robust_decode_step(params, cfg, rep_caches, token,
                       rcfg: RobustDecodeConfig,
                       generator: Optional[torch.Generator] = None,
                       window="cfg"):
    """One replicated decode step -> ([B, V] f32 robust logits, caches).

    With ``share_replica_compute`` the caches are plain [L, B, ...] and one
    forward feeds the whole stack; otherwise they are replica-stacked
    [m, L, B, ...] and all replicas run as one step at batch m * B.
    """
    if rcfg.share_replica_compute:
        logits, new = M.decode_step(params, cfg, rep_caches, token,
                                    window=window)
        logits_r = logits[None].expand((rcfg.m,) + logits.shape)
        return robust_logits(logits_r, rcfg, generator), new
    flat = flatten_replicas(rep_caches, rcfg.m)
    logits_f, flat = M.decode_step(params, cfg, flat, token.repeat(rcfg.m),
                                   window=window)
    logits_r = logits_f.reshape((rcfg.m, token.shape[0]) + logits_f.shape[1:])
    return (robust_logits(logits_r, rcfg, generator),
            unflatten_replicas(flat, rcfg.m))
