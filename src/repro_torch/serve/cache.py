"""Per-slot cache positions (``repro.serve.cache``'s ``vectorize_pos``).

The slot pool of continuous batching (``SlotPool``, ``write_slot``,
``evict_slot``, ``kv_bytes_per_slot``) is not ported yet (ROADMAP.md,
queue A2); it decodes rows at different positions, which the per-row
``KVCache.pos`` below already carries.
"""
from __future__ import annotations

from ..models.attention import KVCache, row_pos

__all__ = ["vectorize_pos"]


def vectorize_pos(caches: KVCache, n_slots: int) -> KVCache:
    """``caches.pos`` as a per-slot [n_slots] int32 vector on the caches'
    device: a scalar broadcasts, a vector of n_slots stays as it is. Each
    row then advances on its own through ``decode_step``."""
    return caches._replace(pos=row_pos(caches.pos, n_slots, caches.k.device))
