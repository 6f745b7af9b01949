"""What the decode caches have in common.

A cache is a NamedTuple: ``attention.KVCache``, ``mamba2.SSMCache``,
``hybrid.HybridCache`` or ``whisper.EncDecCache``. Every field but ``pos`` is a tensor, or None (an
int8 cache's scales), stacked with its layer (or the hybrid's application
of the shared block) on dim 0 and its row on dim 1; ``pos`` is the rows'
[B] int32 positions. The serving code walks a cache's row tensors through
these two helpers and never names a field.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["row_fields", "map_rows"]


def row_fields(caches) -> Tuple[str, ...]:
    """The names of ``caches``' row tensors (row on dim 1): every field
    but ``pos`` that holds a tensor."""
    return tuple(f for f in caches._fields
                 if f != "pos" and getattr(caches, f) is not None)


def map_rows(caches, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``caches`` with ``fn`` applied to each row tensor (``pos`` kept)."""
    return caches._replace(**{f: fn(getattr(caches, f))
                              for f in row_fields(caches)})
