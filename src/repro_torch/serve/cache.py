"""Slot pool of continuous batching and per-slot cache positions
(``repro.serve.cache``'s port).

The pool decouples cache capacity from the request batch: it holds
``n_slots`` cache rows (one per concurrently decoding sequence), each
with its own fill level. Requests are admitted into free slots mid-decode
and retired slots are reused without touching the others.

The port's caches (``KVCache`` [L, rows, T, Hkv, dh], ``SSMCache``'s
states and conv tails [L, rows, ...], a ``HybridCache`` holding both, an
``EncDecCache``'s self and cross K/V) all keep the row on dim 1 and a
per-row ``pos`` [rows] int32 (``vectorize_pos``), so the pool walks a
cache's row tensors (``models.caches.row_fields``); ``slot_dims``,
``repro``'s structural probe, serves the spec layer (it probes on the
meta device at two slot counts). An SSM state is not
masked by a length: a free slot's state keeps moving as the pool
decodes, and an admission overwrites every row tensor of its slot (an
encdec request's cross K/V, over its own frames, too). A pool whose
replicas run replicated holds ``m * n_slots`` rows, replica-major as
``engine.DecodeBuffers`` lays them out (row ``r * n_slots + s`` is
replica r of slot s): the decode step runs them as one batch, with no
flatten per block. Every write is in place into the pool's own tensors,
whose addresses a captured decode step keeps. ``pool_specs`` gives a
pool's partition specs (``dist.sharding.cache_specs``, the rows playing
the batch).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models import model as M
from ..models.attention import row_pos
from ..models.caches import row_fields

__all__ = ["SlotPool", "vectorize_pos", "kv_bytes_per_slot", "pool_caches",
           "init_pool", "write_slot", "evict_slot", "slot_dims",
           "pool_specs", "NO_SLOT_DIM"]

NO_SLOT_DIM = -1  # a field with no slot dim (``repro``'s ``_NO_SLOT_DIM``)


class SlotPool(NamedTuple):
    """Cache pool: model caches + per-slot bookkeeping, all on the device.

    caches:  stacked caches [L, m * n_slots, ...] (a ``KVCache``,
             ``SSMCache``, ``HybridCache`` or ``EncDecCache``) with ``pos``
             [m * n_slots]
             (m = 1 unless the replicas run replicated).
    lengths: [n_slots] int32 — tokens resident per slot (prompt +
             generated).
    active:  [n_slots] bool — slot owned by a live request.
    """

    caches: Any
    lengths: torch.Tensor
    active: torch.Tensor

    @property
    def n_slots(self) -> int:
        return self.lengths.shape[0]

    @property
    def m(self) -> int:
        """Replica rows a slot holds."""
        return self.caches.pos.shape[0] // self.n_slots


def vectorize_pos(caches, n_slots: int):
    """``caches.pos`` as a per-slot [n_slots] int32 vector on the caches'
    device: a scalar broadcasts, a vector of n_slots stays as it is. Each
    row then advances on its own through ``decode_step``."""
    dev = getattr(caches, row_fields(caches)[0]).device
    return caches._replace(pos=row_pos(caches.pos, n_slots, dev))


def pool_caches(cfg, n_slots: int, max_len: int, window="cfg", m: int = 1,
                device=None):
    """Zeroed caches of ``m * n_slots`` rows: K/V in a ring of the
    window's slots (as the prefill makes them), else ``max_len``."""
    window = cfg.sliding_window if window == "cfg" else window
    return M.stack_module(cfg).init_cache(cfg, m * n_slots,
                                          window or max_len, window=None,
                                          device=device)


def kv_bytes_per_slot(make: Callable[[int], Any], n_slots: int) -> int:
    """Device bytes one slot costs in the caches ``make(n_slots)`` builds:
    the sum of every stored tensor's bytes (int8 scales, an SSM's f32
    states and conv tails, an encdec model's cross K/V, and positions
    included, so ``kv_dtype`` shrinking the cache shows here; a replicated
    pool's m replica rows all count) over ``n_slots``. Give ``make`` a
    ``device="meta"`` build and nothing is allocated."""
    caches = make(n_slots)
    total = sum(x.numel() * x.element_size() for x in caches
                if x is not None)
    return total // n_slots


def init_pool(cfg, n_slots: int, max_len: int, window="cfg", m: int = 1,
              device=None) -> SlotPool:
    """Empty pool: zeroed caches, zero lengths, all slots free."""
    caches = pool_caches(cfg, n_slots, max_len, window=window, m=m,
                         device=device)
    dev = caches.pos.device
    return SlotPool(caches=caches,
                    lengths=torch.zeros((n_slots,), dtype=torch.int32,
                                        device=dev),
                    active=torch.zeros((n_slots,), dtype=torch.bool,
                                       device=dev))


def write_slot(pool: SlotPool, req_caches, slot: int,
               length: int) -> SlotPool:
    """Admit one request: copy its batch-1 caches [L, 1, ...] into every
    replica row of ``slot``, in place, every row tensor of the cache, and
    set the slot's position (every replica row), length and liveness.
    Whatever the slot held before (a retired request's rows, an SSM state
    and positions advanced while it sat free) is overwritten. Returns
    ``pool`` (its tensors, written)."""
    n, m = pool.n_slots, pool.m
    for f in row_fields(pool.caches):
        dst, src = getattr(pool.caches, f), getattr(req_caches, f)
        rows = dst.view((dst.shape[0], m, n) + dst.shape[2:])[:, :, slot]
        rows.copy_(src[:, :1])  # [L, 1, ...] over the m replica rows
    pool.caches.pos.view(m, n)[:, slot].fill_(int(length))
    pool.lengths[slot] = int(length)
    pool.active[slot] = True
    return pool


def evict_slot(pool: SlotPool, slot: int) -> SlotPool:
    """Retire a slot. Cache contents stay (masked by the slot's length and
    overwritten on the next admission); only the bookkeeping is cleared."""
    pool.lengths[slot] = 0
    pool.active[slot] = False
    return pool


def slot_dims(make: Callable[[int], Any], n_a: int = 2, n_b: int = 3):
    """Per-field slot-dim index of the caches ``make(n_slots)`` builds:
    ``make`` is probed at two slot counts (give it a ``device="meta"``
    build and nothing is allocated), and each field gets the index of the
    first dim whose size tracked the count, or ``NO_SLOT_DIM``."""
    sa, sb = make(n_a), make(n_b)

    def one(x, y):
        diffs = [i for i, (p, q) in enumerate(zip(x.shape, y.shape))
                 if p != q]
        return diffs[0] if diffs else NO_SLOT_DIM

    return sa._replace(**{f: one(getattr(sa, f), getattr(sb, f))
                          for f in sa._fields if getattr(sa, f) is not None})


def pool_specs(cfg, pool: SlotPool, mesh, batch_axes) -> SlotPool:
    """Partition specs of a pool (``repro``'s ``pool_specs``): the caches
    by ``dist.sharding.cache_specs`` with the pool's rows as the batch
    (``n_slots`` rows unless the replicas run replicated), the
    bookkeeping replicated."""
    from ..dist import sharding as S

    cspecs = S.cache_specs(cfg, pool.caches, mesh, batch_axes,
                           global_batch=pool.caches.pos.shape[0])
    return SlotPool(caches=cspecs, lengths=(None,), active=(None,))
