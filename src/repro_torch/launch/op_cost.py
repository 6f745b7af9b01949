"""Trip-count-aware cost counting of eager PyTorch (``repro.launch.hlo_cost``'s
counterpart).

``repro`` parses the optimized HLO of a compiled step. There is no HLO in
eager PyTorch: the port counts the ops as they dispatch, under a
``TorchDispatchMode`` (:class:`OpCost`), on the meta device (a dry run that
allocates nothing) or on the card (the same count of a real run):

  * flops  - the formulas ``torch.utils.flop_counter`` registers (the
             products and convolutions: 2 * out * contracted, as
             ``hlo_cost`` counts dots), plus each hand-written kernel's
             own ``cost(...)``, which the wrapper records
             (``kernels.build.record_cost``);
  * bytes  - 2 x each dispatched op's output bytes (written once, read
             about once downstream: ``hlo_cost``'s rule), views,
             allocations and plumbing skipped (``_BYTE_SKIP``, as
             ``hlo_cost`` skips bitcasts and tuples; an in-place scatter
             counts its source, ``_SCATTER``), plus the kernels' bytes. Eager ops are not fused, so this counts more than
             ``repro``'s fusion boundaries: that traffic is real;
  * memory - the high-water mark of the storages the counted ops allocate,
             each rounded up to the CUDA caching allocator's 512-byte
             block and freed when its storage dies (``weakref.finalize``).

:func:`counting` opens a count; inside it the kernel wrappers take meta
tensors (``target`` is the device they stand for) and ``attn_backend``
resolves a meta device as ``target``. With ``reckon=True`` a loop written
as ``for i in trips(n)`` runs its body once and counts it n times, as
``hlo_cost`` multiplies a while body by its trip count: the train step's
workers and micro-steps are such loops (``train.step``), each trip the
same ops on the same shapes.

Collectives: each ``torch.distributed`` collective dispatches as a
``c10d`` op (``_COLLECTIVES``), counted into ``Cost.coll`` under
``hlo_cost``'s kind (all-to-all, all-gather, all-reduce, reduce-scatter,
collective-permute) at ``hlo_cost.analyze``'s rule: the bytes of its
operands, what this rank puts in (an all-gather's own shard, an
all-to-all's whole send buffer). Like any op its output counts twice in
``bytes``, as ``hlo_cost`` counts a collective's result there, and
``trips`` multiplies it. The rooted collectives (broadcast, reduce,
gather, scatter) and ``recv`` are not counted: no wire of the port issues
them, and a ``send`` counts as the permute. The count sees the
collectives on meta tensors under a fake process group
(:func:`fake_group`: a dry run of one rank) and on the card under gloo
alike; in one process with no group ``Cost.coll`` stays empty.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import build as _B

__all__ = ["Cost", "OpCost", "counting", "trips", "fake_group",
           "ALLOC_BLOCK", "tensor_bytes"]

# the CUDA caching allocator's smallest block: every allocation rounds up
# to a multiple of it
ALLOC_BLOCK = 512

# ops whose outputs move no bytes: allocations, aliases, host reads
_BYTE_SKIP = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
    "_local_scalar_dense", "detach", "view", "t", "permute", "expand",
    "as_strided", "_reshape_alias", "set_", "resize_",
})

# in-place scatters write their source's elements, not their destination
# (a decode step's K/V row into the whole cache): their bytes are the last
# tensor argument's elements in the destination's dtype
_SCATTER = frozenset({
    "index_copy_", "index_put_", "_index_put_impl_", "index_add_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_",
    "put_",
})


# the c10d ops of torch.distributed's collectives: (hlo_cost's kind, the
# argument holding the operands, the argument the collective writes; a
# send writes nothing on its rank)
_COLLECTIVES = {
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allreduce_": ("all-reduce", 0, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "send": ("collective-permute", 0, None),
}


# per op overload: whether its outputs are fresh storages
_FRESH = {}


def _rounded(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _nbytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (a tensor or a nest of lists)."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (a
    dict/list/tuple nest), each rounded up to ``ALLOC_BLOCK``."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += _rounded(st.nbytes())
    return total


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + mult * v


class OpCost(TorchDispatchMode):
    """The count of one :func:`counting`: ``cost`` (flops, bytes, and the
    collectives' operand bytes by kind in ``coll``), ``kernels`` ({name:
    {"calls", "flops", "bytes"}}), ``by_op`` ({aten name: [calls, flops,
    bytes]}), ``live`` and ``peak`` (bytes of the storages the counted ops
    allocated: now, and at most since the last :meth:`reset_peak`) and
    ``peak_op`` (the op that reached the peak)."""

    def __init__(self, target: str = "cuda", reckon: bool = False):
        super().__init__()
        if target not in ("cuda", "cpu"):
            raise ValueError(f"counting target {target!r}: 'cuda' or 'cpu'")
        self.target, self.reckon = target, reckon
        self.cost = Cost()
        self.kernels: Dict[str, dict] = {}
        self.by_op: Dict[str, list] = {}
        self.mult = 1
        self._live = self._peak = 0
        self.peak_op = None   # the op whose allocation set the peak
        self._tracked = weakref.WeakSet()
        # sizes of storages freed since the last settle: a finalizer may
        # run at any allocation, on either thread, so it only appends
        self._freed = []

    def _settle(self) -> None:
        while self._freed:
            self._live -= self._freed.pop()

    @property
    def live(self) -> int:
        self._settle()
        return self._live

    @property
    def peak(self) -> int:
        return self._peak

    def reset_peak(self) -> None:
        self._peak = self.live

    def _track(self, name, func, out) -> None:
        """Count the storages an op allocates: every output of an op whose
        schema aliases no output to an input (an in-place op, an ``out=``
        variant and a view return an input's storage)."""
        fresh = _FRESH.get(func)
        if fresh is None:
            fresh = _FRESH[func] = not any(
                r.alias_info is not None for r in func._schema.returns)
        if not fresh:
            return
        outs = (out,) if isinstance(out, torch.Tensor) else tree_flatten(
            out)[0]
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._tracked:
                continue
            size = _rounded(st.nbytes())
            self._tracked.add(st)
            weakref.finalize(st, self._freed.append, size)
            self._settle()
            self._live += size
            if self._live > self._peak:
                self._peak, self.peak_op = self._live, name

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        flops, nbytes = self.mult * flops, self.mult * nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += self.mult
        rec[1] += flops
        rec[2] += nbytes

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (``kernels.build.record_cost``)."""
        rec = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0))
        rec["calls"] += self.mult
        rec["flops"] += self.mult * flops
        rec["bytes"] += self.mult * nbytes
        self._add("kernel:" + name, flops, nbytes)

    def _collective(self, name: str, args) -> None:
        """One collective: its operands into ``coll``, its output twice
        into ``bytes``; it allocates nothing."""
        kind, src, dst = _COLLECTIVES[name]
        moved = self.mult * _nbytes(args[src])
        self.cost.coll[kind] = self.cost.coll.get(kind, 0.0) + moved
        self._add(name, 0, 0 if dst is None else 2 * _nbytes(args[dst]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        if name in _COLLECTIVES and func.namespace == "c10d":
            self._collective(name, args)
            return out
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = 0
        if name in _SCATTER:
            src = [a for a in tree_flatten((args[1:], kwargs))[0]
                   if isinstance(a, torch.Tensor)][-1]
            nbytes = 2 * src.numel() * args[0].element_size()
        elif not (getattr(func, "is_view", False) or name in _BYTE_SKIP):
            outs = (out,) if isinstance(out, torch.Tensor) else \
                tree_flatten(out)[0]
            nbytes = 2 * sum(t.numel() * t.element_size() for t in outs
                             if isinstance(t, torch.Tensor))
        self._add(name, flops, nbytes)
        self._track(name, func, out)
        return out


@contextlib.contextmanager
def counting(target: str = "cuda", reckon: bool = False):
    """Count the ops run inside (an :class:`OpCost`, yielded). The kernel
    wrappers take meta tensors here, standing for ``target`` ("cuda": the
    kernels' shape checks and costs; "cpu": their plain versions), and
    record each kernel call's cost, on the meta device or the card alike.
    ``reckon``: :func:`trips` loops run one trip, counted n times."""
    oc = OpCost(target, reckon)
    prev = _B.set_count(oc)
    try:
        with oc:
            yield oc
    finally:
        _B.set_count(prev)


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks on PyTorch's fake backend
    (no communication, no other process: this process is rank 0), yielded
    and destroyed on exit. Its collectives take meta tensors, so a count of
    one rank's step runs on meta as any other. The calling process must
    hold no default process group: this one would replace it."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: this process already holds a "
                           "default process group; count in another "
                           "process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def trips(n: int):
    """``range(n)`` for a loop whose trips run the same ops on the same
    shapes; inside ``counting(..., reckon=True)`` it yields 0 alone and
    counts the body's flops, bytes and kernel calls n times. The body's
    memory is what one trip holds, which every trip holds alike: inside
    any count each trip starts with a cyclic garbage collection, so what
    an earlier trip left in reference cycles (``torch.utils.checkpoint``'s
    frames) is not held into the next at a point that depends on when the
    collector last ran."""
    count = _B.active_count()
    if count is None:
        yield from range(n)
        return
    if not count.reckon or n <= 1:
        for i in range(n):
            gc.collect()
            yield i
        return
    count.mult *= n
    try:
        gc.collect()
        yield 0
    finally:
        count.mult //= n
