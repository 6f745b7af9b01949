"""The robust-backward context (``repro.dist.ctx``'s robust-backward half).

While a ``RobustBackwardState`` is pushed, the layers' ``_dot`` routes
every 3-D x 2-D product through ``dist.robust_reduce.robust_dot``, whose
backward aggregates each weight gradient over the workers with the
state's ``Estimator`` (in-backward robust aggregation, ``repro``'s
IB-RRS). ``repro``'s state names a mesh and its worker axes; on one card
the workers are emulated, so the state holds their count. The mesh half
of ``repro.dist.ctx`` (sharding hints, ``mesh_context``) comes with
multi-card training (ROADMAP.md, A5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

__all__ = ["RobustBackwardState", "push_robust_backward",
           "pop_robust_backward", "robust_backward_state"]


class RobustBackwardState(NamedTuple):
    """Active in-backward aggregation: the worker count and the
    ``core.estimator.Estimator`` that ``robust_dot`` aggregates with."""

    n_workers: int
    estimator: object


_RB_STACK: list = []


def push_robust_backward(state: RobustBackwardState) -> None:
    _RB_STACK.append(state)


def pop_robust_backward() -> RobustBackwardState:
    return _RB_STACK.pop()


def robust_backward_state() -> Optional[RobustBackwardState]:
    """Innermost active robust-backward state, or None."""
    return _RB_STACK[-1] if _RB_STACK else None
