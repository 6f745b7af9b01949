"""Robust aggregation kernels B1 (aggregate) and B4 (aggregate + sample).

``aggregate`` replaces ``repro.kernels.vrmom.aggregate_pallas`` (Pallas
call ``_agg_2d``, l.142/151) and ``aggregate_sample`` replaces
``aggregate_sample_pallas`` (``_tail_3d``, l.242/269). Both CUDA kernels
(``csrc/vrmom.cu``) call one device function, ``agg::aggregate_values``
(``csrc/agg.cuh``), the counterpart of the TPU kernel's ``_agg_block``, so
fused greedy tokens are bit-identical to an argmax over ``aggregate``'s
output; at the serving spec (vrmom, m = 8, K = 8) both run its instance
with the spec fixed at compile time (the same bits). A thread sorts the m
worker values of its coordinates in registers; the stack is read once
with coalesced loads, a thread a coordinate in B1. B4 is one launch a
call: the last block of each row merges the row's per-block top-k
records (:func:`plan_tail` sizes the grid). Both read the stack once and
write little, so their bound on the H100 is their bytes; at the serving
shape both take well over twice that, and what holds them there is not
measured (PERF.md).

vrmom takes any K whose count stays exact (m * K <= 2^24,
:func:`count_table`): the scaled deltas travel in the launch parameters up
to K = 64 and sit in device memory above (csrc/agg.cuh).

Each wrapper launches its kernel for a CUDA tensor, raises on anything
the kernel does not take, and counts its launches in ``.launches`` (one
per eager call: ``build.count_launch``). For a tensor on the CPU it runs
the plain PyTorch version beside it (``aggregate_plain`` /
``aggregate_sample_plain``), which repeats the kernel's arithmetic op
for op. Meta tensors are taken only inside ``launch.op_cost.counting``
(target "cuda": checked as the card's, empty outputs; "cpu": the plain
version), and inside a count each kernel call adds its cost
(:func:`aggregate_cost`, :func:`aggregate_sample_cost`) to it. Selection
follows torch's order: value descending, index ascending, NaN above
every number.
Dispatch policy lives in ``core.estimator.Estimator``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.vrmom import _MAD_CONST, deltas, denominator
from . import build as _B
from .ref import f32_scalar

__all__ = ["aggregate", "aggregate_sample", "aggregate_plain",
           "aggregate_sample_plain", "aggregate_cost",
           "aggregate_sample_cost", "resolve_method", "plan_tail",
           "TailPlan", "count_table", "MAX_M", "MAX_K_BY_VALUE"]

MAX_M = 128  # widest sorting network compiled (csrc/vrmom.cu)
MAX_K_BY_VALUE = 64  # agg::kMaxK: deltas passed in the launch parameters
_METHOD_ID = {"mean": 0, "median": 1, "trimmed_mean": 2, "vrmom": 3}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    # x, out, dtype, m, C, method, K, k_trim, eps, denom, scale, zero_k,
    # table, table_ext, stream
    "agg_launch": [_B.P, _B.P, _B.I, _B.I, _B.LL, _B.I, _B.I, _B.I, _B.F,
                   _B.F, _B.F, _B.I, _B.P, _B.P, _B.P],
    # x, agg_out, rec, tickets, topv, topi, dtype, m, B, V, top_k, method,
    # K, k_trim, eps, denom, scale, zero_k, table, table_ext, stream
    "agg_sample_launch": [_B.P, _B.P, _B.P, _B.P, _B.P, _B.P, _B.I, _B.I,
                          _B.I, _B.I, _B.I, _B.I, _B.I, _B.I, _B.F, _B.F,
                          _B.F, _B.I, _B.P, _B.P, _B.P],
}
TAIL_THREADS = 256  # kTailThreads
MERGE_LISTS = 4     # kMergeLists: record lists per thread of the merge
_PARAMS = {}        # (method, K, m, device) -> Params
_STATE = {}         # (device, stream, B, V, tile, kk) -> (rec, tickets)


class TailPlan(NamedTuple):
    items: int   # coordinates a thread aggregates
    tile: int    # coordinates a tile holds
    chunks: int  # tiles a block aggregates in turn
    n_blk: int   # blocks per row, each leaving one record list
    kk: int      # records a block leaves: min(k, tile)


def plan_tail(m: int, V: int, top_k: int) -> TailPlan:
    """B4's grid along a row of V coordinates, 256 threads a block (the
    same for every row; ``tail_grid`` in csrc/vrmom.cu). Where the m values
    of two coordinates fit in registers (m <= 8) a thread aggregates 2
    (one 8-byte load a row in f32), above m = 8 one. The row's last block
    follows at most 4 record lists a thread, so a row has at most 1,024
    blocks: past 1,024 tiles a block aggregates several in turn."""
    items = 1 if m > 8 else 2
    tile = TAIL_THREADS * items
    n_tiles = -(-V // tile)
    chunks = -(-n_tiles // (MERGE_LISTS * TAIL_THREADS))
    return TailPlan(items, tile, chunks, -(-n_tiles // chunks),
                    min(max(top_k, 1), tile))


def resolve_method(method: str, beta: float, m: int):
    """-> (method, k_trim); "mom" is the median. A trimmed mean must trim at
    least one row per end and keep at least one (``Estimator.validate``
    refuses such specs before dispatch)."""
    method = "median" if method == "mom" else method
    if method not in _METHOD_ID:
        raise ValueError(f"no fused kernel for method {method!r}")
    k_trim = 0
    if method == "trimmed_mean":
        k_trim = int(beta * m)
        if k_trim == 0 or m - 2 * k_trim < 1:
            raise ValueError(
                f"trimmed_mean kernel: beta={beta} at m={m} trims {k_trim} "
                f"rows per end — spec must be validated "
                f"(Estimator.validate) before dispatch")
    return method, k_trim


# -- plain versions -----------------------------------------------------------

def _aggregate_f32(x2, method: str, K: int, k_trim: int, eps: float):
    """The kernel's arithmetic in PyTorch: [m, C] -> [C] f32."""
    xf = x2.float()
    m = xf.shape[0]
    dev = xf.device
    if method == "mean":
        acc = torch.zeros_like(xf[0])
        for i in range(m):
            acc = acc + xf[i]
        return acc * f32_scalar(np.float32(1) / np.float32(m), dev)
    xs = torch.sort(xf, dim=0).values
    if method == "trimmed_mean":
        acc = torch.zeros_like(xf[0])
        for i in range(k_trim, m - k_trim):
            acc = acc + xs[i]
        n = np.float32(m - 2 * k_trim)
        return acc * f32_scalar(np.float32(1) / n, dev)
    med = 0.5 * (xs[(m - 1) // 2] + xs[m // 2])
    if method == "median":
        return med
    ds = torch.sort(torch.abs(xs - med[None]), dim=0).values
    s = 0.5 * (ds[(m - 1) // 2] + ds[m // 2]) / f32_scalar(_MAD_CONST, dev)
    z = (xs - med[None]) / torch.clamp_min(s, eps)[None]
    count = torch.zeros(z.shape[1:], dtype=torch.int64, device=dev)
    for d in deltas(K).tolist():
        count = count + (z <= d).sum(dim=0)
    total = 0.5 * (2 * count - m * K).float()
    out = med - s * total / f32_scalar(denominator(m, K), dev)
    return torch.where(s <= eps, med, out)


def aggregate_plain(x2, method: str = "vrmom", K: int = 10, k_trim: int = 0,
                    eps: float = 1e-12):
    """Plain version of B1: [m, C] -> [C] in x's dtype (f32 math)."""
    return _aggregate_f32(x2, method, K, k_trim, eps).to(x2.dtype)


def _select_plain(a, top_k: int):
    """Top-k of each row of f32 ``a`` [B, V] in (value descending, index
    ascending) order — a stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(a, dim=1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k].to(torch.int32)


def aggregate_sample_plain(x, method: str = "vrmom", K: int = 10,
                           k_trim: int = 0, top_k: int = 0,
                           eps: float = 1e-12, with_agg: bool = True):
    """Plain version of B4 on [m, B, V]: see :func:`aggregate_sample`."""
    m, B, V = x.shape
    a = _aggregate_f32(x.reshape(m, -1), method, K, k_trim, eps).reshape(B, V)
    agg = a.to(x.dtype) if with_agg else None
    if top_k == 0:
        return agg, torch.argmax(a, dim=-1).to(torch.int32)
    topv, topi = _select_plain(a, top_k)
    return agg, topv, topi


# -- costs ---------------------------------------------------------------------

def aggregate_cost(shape, dtype=torch.float32):
    """(flops, bytes) of one B1 call on an ``[m, ...]`` stack: the stack
    read once and the aggregate written once, in its dtype. Its
    operations are comparisons and adds, which a FLOP count (as
    ``torch.utils.flop_counter`` counts elementwise work) takes as 0."""
    m, C = shape[0], math.prod(shape[1:])
    return 0, (m + 1) * C * dtype.itemsize


def aggregate_sample_cost(shape, dtype=torch.float32, top_k: int = 0,
                          with_agg: bool = True):
    """(flops, bytes) of one B4 call on an ``[m, B, V]`` stack: the stack
    read once, the ``[B, V]`` aggregate (``with_agg``) and the ``[B, k]``
    f32 values and int32 indices written once; 0 FLOPs, as for B1."""
    m, B, V = shape
    size = dtype.itemsize
    return 0, (m * B * V * size + (B * V * size if with_agg else 0)
               + B * max(top_k, 1) * 8)


# -- kernel wrappers ----------------------------------------------------------

def _lib():
    return _B.load("vrmom", _SIGNATURES)


def _check_stack(x, what: str):
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: tensor on {x.device}, expected cuda or cpu")
    if x.dtype not in _DTYPE_ID:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")
    if not 1 <= x.shape[0] <= MAX_M:
        raise ValueError(f"{what}: m={x.shape[0]} outside 1..{MAX_M}, the "
                         f"widest sorting network the kernel compiles")


def count_table(K: int):
    """(table, S, zero_k): how B1/B4 count z <= Delta_k on the FP32 adders
    (csrc/agg.cuh). S = 2^(24 - e), e the least exponent of a nonzero
    delta (at most 0), so every float z != Delta_k lies at least 1 / S from
    it; ``table`` holds the f32 deltas times S (exact: S is a power of
    two), ascending; ``zero_k`` is the index of the delta 0 of an odd K,
    else -1."""
    d = deltas(K)
    nz = d[d != 0]
    e_min = min(0, int(np.frexp(np.abs(nz))[1].min()) - 1) if nz.size else 0
    scale = np.float32(2.0 ** (24 - e_min))
    zero = np.flatnonzero(d == 0)
    return d * scale, scale, int(zero[0]) if zero.size else -1


class _Params(NamedTuple):
    denom: float
    scale: float
    zero_k: int
    table: object  # the K scaled deltas: numpy f32 for K <= 64 (copied into
    # the launch parameters), else a tensor on the device; None: no vrmom


def _params(method: str, K: int, m: int, device) -> _Params:
    """The launch parameters of a spec on one device, computed once. The
    count is the brute count's integer while its sum of m * K ones is exact
    in f32 (m * K <= 2^24); a larger spec raises."""
    key = (method, K, m, device)
    hit = _PARAMS.get(key)
    if hit is not None:
        return hit
    if method != "vrmom":
        hit = _Params(0.0, 1.0, -1, None)
    else:
        if K < 1 or m * K > 2 ** 24:
            raise ValueError(
                f"vrmom kernel: K={K} at m={m} — the count of z <= Delta_k "
                f"sums m * K ones in f32, exact only up to 2^24 "
                f"(and K >= 1)")
        table, scale, zero_k = count_table(K)
        if K > MAX_K_BY_VALUE:
            table = torch.from_numpy(table).to(device)
        hit = _Params(float(denominator(m, K)), float(scale), zero_k, table)
    _PARAMS[key] = hit
    return hit


def _table_ptrs(p: _Params):
    """(table, table_ext) arguments of a launch: host or device memory."""
    if p.table is None:
        return None, None
    if isinstance(p.table, np.ndarray):
        return p.table.ctypes.data, None
    return None, p.table.data_ptr()


def _launch_state(device, stream: int, B: int, V: int, plan: TailPlan):
    """(records pointer, tickets pointer, records, tickets) of one shape on
    one stream, made at its first call: B * n_blk * kk 64-bit records and
    B int32 ticket counters (zeroed once; every launch leaves them zero).
    Calls of one shape on one stream share them, ordered by the stream."""
    key = (device.index, stream, B, V, plan.tile, plan.kk)
    st = _STATE.get(key)
    if st is None:
        rec = torch.empty((B, plan.n_blk, plan.kk), dtype=torch.int64,
                          device=device)
        tickets = torch.zeros(B, dtype=torch.int32, device=device)
        st = _STATE[key] = (rec.data_ptr(), tickets.data_ptr(), rec, tickets)
    return st


def aggregate(x, method: str = "vrmom", K: int = 10, beta: float = 0.1,
              eps: float = 1e-12):
    """B1: fused aggregation over axis 0, ``[m, ...] -> [...]``.

    ``method``: median/mom | vrmom | trimmed_mean | mean. Trailing dims are
    coordinates. f32 or bf16 in, f32 math, the input dtype out.
    """
    m = x.shape[0]
    method, k_trim = resolve_method(method, beta, m)
    shape = x.shape[1:]
    target = _B.device_kind(x.device, "aggregate")
    if target == "cpu":
        return aggregate_plain(x.reshape(m, -1), method, K, k_trim,
                               eps).reshape(shape)
    _check_stack(x, "aggregate")
    p = _params(method, K, m, x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    C = x[0].numel()
    if C == 0:
        return out
    _B.record_cost("aggregate", *aggregate_cost(x.shape, x.dtype))
    if x.device.type == "meta":
        return out
    err = _lib().agg_launch(
        x.data_ptr(), out.data_ptr(), _DTYPE_ID[x.dtype], m, C,
        _METHOD_ID[method], K, k_trim, eps, p.denom, p.scale, p.zero_k,
        *_table_ptrs(p), _B.stream_handle(x.device))
    _B.check(err, "aggregate")
    _B.count_launch(aggregate)
    return out


aggregate.launches = 0


def aggregate_sample(x, method: str = "vrmom", K: int = 10, beta: float = 0.1,
                     top_k: int = 0, eps: float = 1e-12,
                     with_agg: bool = True):
    """B4: fused aggregation + sampling tail over an ``[m, B, V]`` stack.

    Returns ``(agg, tok [B] int32)`` for ``top_k == 0`` (greedy; ``tok[b]``
    bit-identical to ``argmax(aggregate(x)[b])``, first occurrence on
    ties), or ``(agg, topv [B, k] f32, topi [B, k] int32)`` in
    (value descending, index ascending) order, NaN ranking above every
    number as in ``torch.argmax`` / ``torch.sort``. ``with_agg=False``
    writes no ``[B, V]`` aggregate and returns ``agg=None``. One call is
    one launch; calls of one shape on one stream share scratch and must be
    ordered on that stream.
    """
    if x.ndim != 3:
        raise ValueError(f"fused tail wants [m, B, V] stacks, got "
                         f"{tuple(x.shape)}")
    m, B, V = x.shape
    if not 0 <= top_k <= V:
        raise ValueError(f"top_k={top_k} out of range for V={V}")
    method, k_trim = resolve_method(method, beta, m)
    target = _B.device_kind(x.device, "aggregate_sample")
    if target == "cpu":
        return aggregate_sample_plain(x, method, K, k_trim, top_k, eps,
                                      with_agg)
    _check_stack(x, "aggregate_sample")
    plan = plan_tail(m, V, top_k)
    p = _params(method, K, m, x.device)
    dev = x.device
    k = max(top_k, 1)
    topv = torch.empty((B, k), dtype=torch.float32, device=dev)
    topi = torch.empty((B, k), dtype=torch.int32, device=dev)
    agg = torch.empty((B, V), dtype=x.dtype, device=dev) if with_agg else None
    _B.record_cost("aggregate_sample", *aggregate_sample_cost(
        x.shape, x.dtype, top_k, with_agg))
    if dev.type == "meta":
        return (agg, topi[:, 0]) if top_k == 0 else (agg, topv, topi)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rec, tickets = _launch_state(dev, stream, B, V, plan)[:2]
    err = _lib().agg_sample_launch(
        x.data_ptr(), agg.data_ptr() if with_agg else None, rec, tickets,
        topv.data_ptr(), topi.data_ptr(), _DTYPE_ID[x.dtype], m, B, V, k,
        _METHOD_ID[method], K, k_trim, eps, p.denom, p.scale, p.zero_k,
        *_table_ptrs(p), stream)
    _B.check(err, "aggregate_sample")
    _B.count_launch(aggregate_sample)
    if top_k == 0:
        return agg, topi[:, 0]
    return agg, topv, topi


aggregate_sample.launches = 0
