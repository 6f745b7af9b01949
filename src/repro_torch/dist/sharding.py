"""Partition-spec rules for params, batches, caches and optimizer state
(``repro.dist.sharding``'s port).

A spec is a plain tuple with one entry a dim: ``None`` (replicated), an
axis name, or a tuple of two or more axis names — ``repro``'s
``PartitionSpec`` entry for entry (which keeps a tuple of one name as the
name). A rule is a function of shapes and mesh sizes alone: the shape
trees are the port's dict trees whose leaves are shape tuples
(``convert.expected_shapes``) or tensors (meta tensors allocate nothing),
and the mesh is a ``launch.mesh.MeshShape`` or a ``DeviceMesh``.

Every rule is divisibility-aware: an axis is placed on a dim only when its
size divides the dim and the dim is at least twice the axis size. A rule
that does not fit degrades to replication, never to an error, so one
config gets specs on the 2x16x16 production mesh and on a 4x2 host mesh.
``model`` is the tensor-parallel axis, ``data`` the FSDP/batch axis,
``pod`` an optional outer batch axis; (``pod``, ``data``) are the worker
axes of the robust aggregation. ``to_named`` lays a spec tree onto a real
``DeviceMesh`` as DTensor placements.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from ..tree import at as _at, paths as _paths, tree_map
from .ctx import axis_sizes

__all__ = ["param_specs", "batch_axes_for", "batch_specs", "cache_specs",
           "stacked_grad_specs", "opt_state_specs", "to_named", "NamedSpec",
           "leaf_shape"]

_WORKER_AXIS_ORDER = ("pod", "data")


def leaf_shape(leaf) -> Tuple[int, ...]:
    """The shape of a shape-tree leaf: a tensor's, or the tuple itself."""
    return tuple(int(d) for d in getattr(leaf, "shape", leaf))


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis
    name is that name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _axis(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _fits(dim: int, ax: int) -> bool:
    """Is placing an axis of size ``ax`` on a dim of size ``dim`` sane?"""
    return ax > 1 and dim % ax == 0 and dim >= 2 * ax


def _map_with_path(fn, tree, prefix=()):
    """``fn(key path, leaf)`` over a dict tree, its structure kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(shapes, mesh):
    """Spec tree for a params shape tree (``repro``'s placement rules):

    * embed ``[V, D]`` / lm_head ``[D, V]`` — model on the vocab dim when it
      fits, else on ``D``, else dropped; data on the dim that remains.
    * ``wq/wk/wv [L, D, H, dh]`` — model on the head dim only when it fits
      (odd head counts are replicated, never moved to ``dh``); data on
      ``D``. ``wo [L, H, dh, D]`` — model on heads, data on ``D``.
    * ``w_gate/w_up [..., D, F]``, ``w_down [..., F, D]`` — model on ``F``,
      data on ``D``; expert and layer-stack dims replicated.
    * ``router [..., D, E]`` and every other 2-D+ leaf — model on the last
      dim, data on the second-to-last, each only when it fits.
    """
    tp = _axis(mesh, "model")
    dp = _axis(mesh, "data")

    def spec_for(path, leaf):
        shape = leaf_shape(leaf)
        nd = len(shape)
        if nd <= 1:
            return (None,) * nd
        name = path[-1] if path else ""

        if name in ("embed", "lm_head"):
            vdim = 0 if name == "embed" else 1
            entries = [None, None]
            if _fits(shape[vdim], tp):
                entries[vdim] = "model"
            elif _fits(shape[1 - vdim], tp):
                entries[1 - vdim] = "model"
            other = entries.index(None) if None in entries else None
            if other is not None and _fits(shape[other], dp):
                entries[other] = "data"
            return tuple(entries)

        if name in ("wq", "wk", "wv", "wo") and nd in (3, 4):
            off = nd - 3
            h_dim = off + (0 if name == "wo" else 1)
            d_dim = off + (2 if name == "wo" else 0)
            entries = [None] * nd
            if _fits(shape[h_dim], tp):
                entries[h_dim] = "model"
            if _fits(shape[d_dim], dp):
                entries[d_dim] = "data"
            return tuple(entries)

        if name in ("w_gate", "w_up", "w_down"):
            f_dim = nd - 1 if name != "w_down" else nd - 2
            d_dim = nd - 2 if name != "w_down" else nd - 1
            entries = [None] * nd
            if _fits(shape[f_dim], tp):
                entries[f_dim] = "model"
            if _fits(shape[d_dim], dp):
                entries[d_dim] = "data"
            return tuple(entries)

        # the router and the generic rule: model on the last dim, data on
        # the second-to-last
        entries = [None] * nd
        if _fits(shape[-1], tp):
            entries[-1] = "model"
        if _fits(shape[-2], dp):
            entries[-2] = "data"
        return tuple(entries)

    return _map_with_path(spec_for, shapes)


def batch_axes_for(mesh, global_batch: int):
    """Mesh axes to shard the batch dim over, or None when nothing fits:
    the full worker-axis tuple first, then without its outer axes
    ((pod, data) -> (data,) -> None)."""
    sizes = axis_sizes(mesh)
    names = [a for a in _WORKER_AXIS_ORDER if a in sizes]
    for i in range(len(names)):
        axes = tuple(names[i:])
        total = 1
        for a in axes:
            total *= sizes[a]
        if total > 0 and global_batch % total == 0:
            return axes
    return None


def batch_specs(specs, batch_axes):
    """Spec tree for a batch tree: dim 0 on ``batch_axes``, the rest
    replicated."""
    def one(leaf):
        nd = len(leaf_shape(leaf))
        if batch_axes is None or nd == 0:
            return (None,) * nd
        return (_entry(batch_axes),) + (None,) * (nd - 1)

    return tree_map(one, specs)


def _cache_fields(caches):
    return [f for f in caches._fields if getattr(caches, f) is not None]


def cache_specs(cfg, cache_shapes, mesh, batch_axes, global_batch=None):
    """Specs for a decode cache (the port's cache NamedTuples, fields as
    tensors; None fields stay None): the batch dim on ``batch_axes``, the
    widest dim after it on ``model`` when it fits, layer-stack dims
    replicated. The batch dim is found by size (``global_batch``;
    preference dim 1, then 2, then 0, as ``repro``'s); without it the cache
    stays batch-replicated."""
    tp = _axis(mesh, "model")

    def one(leaf):
        shape = leaf_shape(leaf)
        nd = len(shape)
        entries = [None] * nd
        b_dim = None
        if global_batch is not None and batch_axes is not None and nd >= 2:
            cands = [i for i, d in enumerate(shape) if d == global_batch]
            for pref in (1, 2, 0):
                if pref in cands:
                    b_dim = pref
                    break
            if b_dim is None and cands:
                b_dim = cands[0]
            if b_dim is not None:
                entries[b_dim] = _entry(batch_axes)
        if b_dim is not None and nd > b_dim + 1:
            cand = max(range(b_dim + 1, nd), key=lambda i: shape[i])
            if _fits(shape[cand], tp):
                entries[cand] = "model"
        return tuple(entries)

    return cache_shapes._replace(**{
        f: one(getattr(cache_shapes, f)) for f in _cache_fields(cache_shapes)})


def stacked_grad_specs(params_specs, worker_axes, mesh=None, shapes=None):
    """Specs for per-worker stacked grads ``[n_workers, *param_shape]``:
    dim 0 on the worker axes, the param spec shifted right by one with
    every worker axis taken out of it (an axis appears once in a spec)."""
    wa = tuple(worker_axes)

    def one(spec):
        cleaned = []
        for e in spec:
            if e is None:
                cleaned.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a not in wa)
                cleaned.append(_entry(kept) if kept else None)
            else:
                cleaned.append(None if e in wa else e)
        return (_entry(wa) if wa else None,) + tuple(cleaned)

    return tree_map(one, params_specs)


def opt_state_specs(opt_state_shapes, params, params_specs):
    """Specs for an optimizer state mirroring the params tree: a leaf of a
    param's shape takes that param's spec (the first in tree order);
    adafactor's factored ``vr`` takes ``spec[:-1]`` and ``vc`` the spec
    without dim -2; anything else is replicated."""
    shape2spec = {}
    for (path, p) in _paths(params):
        spec = _at(params_specs, path)
        shape2spec.setdefault(leaf_shape(p), spec)

    def leaf_spec(path, leaf):
        shp = leaf_shape(leaf)
        if shp in shape2spec:
            return shape2spec[shp]
        name = path[-1] if path else ""
        if name in ("vr", "vc"):
            for pshape, s in shape2spec.items():
                entries = list(s) + [None] * (len(pshape) - len(s))
                if name == "vr" and pshape[:-1] == shp:
                    return tuple(entries[:-1])
                if name == "vc" and pshape[:-2] + pshape[-1:] == shp:
                    return tuple(entries[:-2]) + (entries[-1],)
        return (None,) * len(shp)

    return _map_with_path(leaf_spec, opt_state_shapes)


class NamedSpec(NamedTuple):
    """A spec laid onto a ``DeviceMesh``: ``DTensor`` placements, one a
    mesh dim (``Shard(d)`` where the spec puts that axis on dim d, else
    ``Replicate()``)."""

    mesh: object
    placements: tuple


def to_named(mesh, specs):
    """Spec tree -> ``NamedSpec`` tree on the ``DeviceMesh`` ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())

    def one(spec):
        where = {}
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    if a not in names:
                        raise ValueError(f"spec {spec}: axis {a!r} is not "
                                         f"in the mesh {names}")
                    where[a] = d
        return NamedSpec(mesh, tuple(
            Shard(where[a]) if a in where else Replicate() for a in names))

    return tree_map(one, specs)
