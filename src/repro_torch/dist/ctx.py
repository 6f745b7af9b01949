"""Ambient distributed context (``repro.dist.ctx``'s port).

Model layers take no mesh argument, so the active mesh lives in a context
stack that the serve steps push via ``mesh_context``. Layers then ask two
questions:

* ``axis_size(name)`` — how many shards along a mesh axis (1 when no
  mesh is active or the axis does not exist).
* ``constrain(x, *entries)`` — ``repro``'s best-effort
  ``with_sharding_constraint``. ``repro``'s does nothing off a trace, and
  the port is eager, so this one checks its entries against the ambient
  mesh (``_clean_entry``: an axis the mesh lacks, or a product that does
  not divide the dim, degrades to ``U``) and returns its input.

No layer of the port asks either question yet (ROADMAP A5d): the serve
steps push their mesh and nothing reads it, so this half changes no
result until a sharded layer does.

A mesh here is a ``launch.mesh.MeshShape`` or a
``torch.distributed.device_mesh.DeviceMesh`` (``axis_sizes`` reads
either).

The module also holds the robust-backward state: while a
``RobustBackwardState`` is pushed, the layers' ``_dot`` routes every 3-D
x 2-D product through ``dist.robust_reduce.robust_dot``, whose backward
aggregates each weight gradient over the workers with the state's
``Estimator`` (``repro``'s IB-RRS). ``repro``'s state names a mesh and its
worker axes; the port's holds the worker count and, over several ranks,
the process group whose ranks hold the workers (``None``: every worker in
this process).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

__all__ = ["U", "mesh_context", "current_mesh", "axis_size", "axis_sizes",
           "constrain", "RobustBackwardState", "push_robust_backward",
           "pop_robust_backward", "robust_backward_state"]


class _Unconstrained:
    """``repro``'s ``P.UNCONSTRAINED``: a dim left to the partitioner."""

    def __repr__(self) -> str:
        return "U"


U = _Unconstrained()

_MESH_STACK: list = []


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``MeshShape`` or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:   # a DeviceMesh
        names = mesh.mesh_dim_names or ()
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in names}


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh for constrain()/axis_size()."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh():
    """The innermost active mesh, or None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def axis_size(name: str) -> int:
    """Size of mesh axis ``name`` in the ambient mesh (1 if absent)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def _clean_entry(mesh, entry, dim: int):
    """Validate one spec entry against the mesh and dim size.

    Unknown axes and non-dividing products degrade to ``U`` — callers
    state intent for the production mesh, and smaller meshes must not
    error."""
    if entry is U or entry is None:
        return entry
    sizes = axis_sizes(mesh)
    names = entry if isinstance(entry, tuple) else (entry,)
    kept = tuple(a for a in names if sizes.get(a, 1) > 1)
    if not kept:
        return U
    total = 1
    for a in kept:
        total *= sizes[a]
    if dim % total:
        return U
    return kept if len(kept) > 1 else kept[0]


def constrain(x, *entries):
    """Check ``entries`` (one a dim of ``x``: an axis name, a tuple of
    names, None or ``U``) against the ambient mesh and return ``x``: an
    eager tensor has nothing to constrain (module docstring)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for e, d in zip(entries, x.shape):
        _clean_entry(mesh, e, d)
    return x


# ---------------------------------------------------------------------------
# Robust-backward state (consumed by robust_reduce.robust_dot)
# ---------------------------------------------------------------------------

class RobustBackwardState(NamedTuple):
    """Active in-backward aggregation: the worker count, the
    ``core.estimator.Estimator`` that ``robust_dot`` aggregates with, the
    process group whose ranks hold the workers (None: all here) and, over
    a group, the indices of the leaves whose gradients still need the sum
    over the ranks after the backward (``dist.robust_reduce
    .mark_wire_products`` fills it)."""

    n_workers: int
    estimator: object
    group: Optional[object] = None
    summed: Optional[set] = None


_RB_STACK: list = []


def push_robust_backward(state: RobustBackwardState) -> None:
    _RB_STACK.append(state)


def pop_robust_backward() -> RobustBackwardState:
    return _RB_STACK.pop()


def robust_backward_state() -> Optional[RobustBackwardState]:
    """Innermost active robust-backward state, or None."""
    return _RB_STACK[-1] if _RB_STACK else None
