"""Fault injection for the consensus backend (``repro.dist.faults``' port).

A :class:`FaultPlan` is a hashable spec of the failures injected into a
consensus run: iid message dropout, permanent crashes and stale
stragglers. The spec is static; the randomness (which message is dropped
in which round) is a tensor of uniforms ``[..., rounds, n, n]`` drawn at
once for every round of a run from a ``torch.Generator`` on the stack's
device, where ``repro`` folds the round index into a PRNG key. A caller
may hand the uniforms in (``draws=``): JAX and torch streams never match,
so the parity tests pass ``repro``'s own draws and both packages then see
the same reception matrices.

Worker-index convention (``n`` = consensus peers), as in ``repro``:

* **crashed** workers occupy the *first* ``n_crashed`` indices: they
  stop sending permanently from round ``crash_round`` on;
* **stragglers** occupy the next ``n_stragglers`` indices: they keep
  sending, but serve the value they held ``stale_rounds`` rounds ago;
* **Byzantine** workers (``core.attacks.byzantine_mask``) occupy the
  *last* rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..lint.hashguard import check_hashable_fields

__all__ = ["FaultPlan"]


class FaultPlan(NamedTuple):
    """Static description of the failures injected into a consensus run.

    ``dropout``      — iid per-round, per-(receiver, sender) message
                       loss probability (self-delivery never drops).
    ``n_crashed``    — workers that crash permanently...
    ``crash_round``  — ...at the start of this round (0 = from the
                       first exchange; fail-stop, not fail-recover).
    ``n_stragglers`` — workers whose sends are stale:
    ``stale_rounds`` — they serve the value held ``k`` rounds earlier
                       (their round-0 value for the first ``k`` rounds).
    """
    dropout: float = 0.0
    n_crashed: int = 0
    crash_round: int = 0
    n_stragglers: int = 0
    stale_rounds: int = 1

    @property
    def trivial(self) -> bool:
        """True when the plan injects nothing: the fault-free path (one
        ``Estimator`` aggregate a round, no masking) is exact."""
        return (self.dropout == 0.0 and self.n_crashed == 0
                and self.n_stragglers == 0)

    def validate(self, n: int) -> "FaultPlan":
        if not 0.0 <= float(self.dropout) < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if self.n_crashed < 0 or self.n_stragglers < 0:
            raise ValueError("n_crashed / n_stragglers must be >= 0")
        if self.n_crashed + self.n_stragglers > n:
            raise ValueError(
                f"FaultPlan places {self.n_crashed} crashed + "
                f"{self.n_stragglers} straggler workers on only {n} peers")
        if self.n_stragglers and self.stale_rounds < 1:
            raise ValueError("stale_rounds must be >= 1 when stragglers > 0")
        return self

    def crashed_mask(self, n: int, device=None) -> torch.Tensor:
        """[n] bool — workers that *will* crash (the first ``n_crashed``)."""
        return torch.arange(n, device=device) < self.n_crashed

    def straggler_mask(self, n: int, device=None) -> torch.Tensor:
        """[n] bool — stale senders (the indices after the crashed block)."""
        idx = torch.arange(n, device=device)
        return ((idx >= self.n_crashed)
                & (idx < self.n_crashed + self.n_stragglers))

    def crashed_at(self, n: int, p: int, device=None) -> torch.Tensor:
        """[n] bool — workers already crashed in round ``p``."""
        return self.crashed_mask(n, device) & (p >= self.crash_round)

    def uniforms(self, n: int, rounds: int, batch=(), generator=None,
                 device=None) -> torch.Tensor:
        """The draws of a run: uniforms ``[*batch, rounds, n, n]`` in [0, 1)
        from ``generator`` (a fresh one seeded 0 when None, as ``repro``
        takes ``PRNGKey(0)``), one ``[n, n]`` matrix a round and batch
        index."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return torch.rand(tuple(batch) + (rounds, n, n), generator=generator,
                          device=device)

    def recv_matrices(self, n: int, rounds: int, *, batch=(), draws=None,
                      generator=None, device=None) -> torch.Tensor:
        """``recv[..., p, i, j]``: receiver ``i`` got sender ``j``'s
        round-``p`` message, for every round of a run at once: ``[*batch,
        rounds, n, n]`` bool under dropout, ``[rounds, n, n]`` without.

        The diagonal is always True; every other edge drops when its
        uniform is below ``dropout`` (``draws``, or :meth:`uniforms` from
        ``generator``); the columns of crashed senders go False once a
        round reaches ``crash_round``. ``repro``'s ``recv_matrix`` of
        round ``p`` on the uniforms ``fold_in(key, p)`` gives, is
        ``recv[p]``."""
        eye = torch.eye(n, dtype=torch.bool, device=device)
        if self.dropout > 0.0:
            want = tuple(batch) + (rounds, n, n)
            if draws is None:
                u = self.uniforms(n, rounds, batch, generator, device)
            else:
                u = torch.as_tensor(draws, dtype=torch.float32, device=device)
                if tuple(u.shape) != want:
                    raise ValueError(f"draws of shape {tuple(u.shape)}; this "
                                     f"run needs {want} (batch, rounds, n, n)")
            # the f32 threshold, as repro compares f32 uniforms with it
            recv = eye | (u >= float(np.float32(self.dropout)))
        else:
            recv = torch.ones((rounds, n, n), dtype=torch.bool, device=device)
        if self.n_crashed:
            p = torch.arange(rounds, device=device)[:, None]
            crashed = self.crashed_mask(n, device)[None] & (
                p >= self.crash_round)
            recv = recv & ~crashed[:, None, :]
        return recv


# A plan is a static spec that keys caches and compares by value, as in
# repro: reject unhashable fields at construction, naming the field.
# (``_replace`` builds through the raw tuple constructor and skips this.)
_orig_new = FaultPlan.__new__


def _checked_new(cls, *args, **kwargs):
    plan = _orig_new(cls, *args, **kwargs)
    check_hashable_fields(plan)
    return plan


FaultPlan.__new__ = _checked_new
