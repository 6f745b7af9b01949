"""Construction-time hashability backstop for static specs
(``repro.lint.hashguard``'s port).

The RL004 AST rule catches the declared shape of a config class; this
helper catches the values. ``check_hashable_fields`` is called from
``Estimator.__new__``, ``RobustDecodeConfig.__post_init__``,
``ArchConfig.__post_init__`` and ``FaultPlan.__new__``, so a spec
carrying a list/dict/tensor field fails at construction, naming the
offending field, instead of later as a TypeError where the spec keys a
cache (``ServeEngine.graphs`` is keyed by ``Sampling``; the kernels'
tables by their spec).

Stdlib-only; must import without torch.
"""
from __future__ import annotations

from typing import Any, Iterable, Tuple

__all__ = ["check_hashable_fields", "UnhashableFieldError"]


class UnhashableFieldError(TypeError):
    """A static spec was constructed with an unhashable field."""


def _field_items(obj: Any) -> Iterable[Tuple[str, Any]]:
    if hasattr(obj, "_asdict"):          # NamedTuple
        return obj._asdict().items()
    if hasattr(obj, "__dataclass_fields__"):
        return ((name, getattr(obj, name))
                for name in obj.__dataclass_fields__)
    return vars(obj).items()


def check_hashable_fields(obj: Any) -> None:
    """Raise :class:`UnhashableFieldError` naming the first unhashable
    field of a spec object (NamedTuple or dataclass instance)."""
    cls = type(obj).__name__
    for name, value in _field_items(obj):
        try:
            hash(value)
        except TypeError:
            raise UnhashableFieldError(
                f"{cls}.{name} = {value!r} ({type(value).__name__}) is "
                f"unhashable; {cls} is a static spec that keys caches and "
                f"every field must be hashable (use a tuple / frozen "
                f"type) [reprolint RL004]") from None
