"""Dict trees of tensors: the params, grads, stacks and optimizer states.

The port keeps ``repro``'s pytrees as nested dicts. Leaves are visited in
JAX's flatten order (dict keys sorted, recursively), so a flattened tree
lines up leaf for leaf with ``jax.tree.leaves`` of ``repro``'s."""
from __future__ import annotations

__all__ = ["paths", "at", "leaves", "tree_map", "unflatten"]


def paths(tree, prefix=()):
    """(key path, leaf) pairs of a dict tree, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def at(tree, path):
    """The entry of a dict tree at key ``path`` (a leaf or a subtree)."""
    for k in path:
        tree = tree[k]
    return tree


def leaves(tree):
    """The leaves of a dict tree, keys sorted at every level."""
    return (leaf for _, leaf in paths(tree))


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def unflatten(like, flat):
    """A tree of ``like``'s structure holding ``flat`` (in ``leaves``
    order)."""
    return _build(like, iter(flat))


def _build(t, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would hold ``flat`` (a step's gradients)
    # until the cyclic collector ran
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)
