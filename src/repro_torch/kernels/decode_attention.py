"""Decode-attention kernel B3 (one query token against a KV cache).

``decode_attention`` replaces ``repro.kernels.decode_attention
.decode_attention`` (Pallas call ``_decode_grouped``, l.158/246, with both
bodies ``_kernel_narrow`` and ``_kernel_wide``). The CUDA kernel
(``csrc/decode_attention.cu``) splits the kv axis across blocks
(flash-decoding): each block covers the whole query group of one (kv
head, row) over a span of 32-key chunks, reads the cache in place (never
repeated to H heads) with 16-byte ``cp.async`` copies, multiplies int8
dequant scales in at load and keeps the online softmax in f32; the last
block of each (row, kv head) merges the chunks in order, in the same
launch. :func:`plan_splits` picks the split; one call is one launch.

The wrapper launches the kernel for CUDA tensors (q f32/bf16, cache
f32/bf16/int8, dh in ``HEAD_DIMS``, H / Hkv <= ``MAX_GROUP``, contiguous),
raises on anything else, and counts launches in
``decode_attention.launches`` (eager ones: ``build.count_launch``); for
CPU tensors it runs ``decode_attention_plain``. Meta tensors are taken
only inside ``launch.op_cost.counting`` (target "cuda": checked as the
card's, an empty output; "cpu": the plain version), and inside a count
each kernel call adds :func:`cost` to it. A python-int ``kv_len``
goes to the kernel as a scalar argument, so a call makes no other device
work. Calls of one shape on one stream share their scratch and ticket
counters, so they must be ordered on that stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build as _B

__all__ = ["decode_attention", "decode_attention_plain", "cost", "lengths",
           "plan_splits", "SplitPlan", "HEAD_DIMS", "MAX_GROUP", "CHUNK"]

HEAD_DIMS = (32, 64, 96, 112, 128)  # the instances csrc compiles
MAX_GROUP = 16  # query heads per kv head (kMaxGroup)
_Q_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
CHUNK = 32      # keys per chunk record (kChunk)
H100_SMS = 132
_SIGNATURES = {
    # q, k, v, k_scale, v_scale, lens, len_all, out, part, tickets,
    # q_dtype, kv_dtype, B, T, H, Hkv, dh, n_split, chunks_per_split, stream
    "decode_attention_fwd": [_B.P, _B.P, _B.P, _B.P, _B.P, _B.P, _B.I, _B.P,
                             _B.P, _B.P, _B.I, _B.I, _B.I, _B.I, _B.I, _B.I,
                             _B.I, _B.I, _B.I, _B.P],
}
NEG_INF = -1e30
_STATE = {}     # (device, stream, B, T, H, Hkv, dh) -> _launch_state(...)


class SplitPlan(NamedTuple):
    n_split: int            # blocks along the kv axis per (row, kv head)
    chunks_per_split: int   # 32-key chunks each of those blocks covers
    n_chunks: int           # ceil(T / 32): chunk records per (row, kv head)
    scratch_shape: tuple    # f32 records (acc[G][dh], m[G], l[G]) per chunk


def plan_splits(B: int, Hkv: int, T: int, G: int, dh: int,
                sms: int = H100_SMS) -> SplitPlan:
    """Split of the kv axis for ``B * Hkv`` (row, kv head) pairs: about two
    waves of blocks on ``sms`` multiprocessors, each split a whole number
    of 32-key chunks and no split empty at full length. The result does not
    depend on the split (see the kernel's note), only the speed does."""
    n_chunks = max(1, -(-T // CHUNK))
    want = max(1, -(-2 * sms // (B * Hkv)))
    cps = -(-n_chunks // min(n_chunks, want))
    return SplitPlan(-(-n_chunks // cps), cps, n_chunks,
                     (B, Hkv, n_chunks, G * (dh + 2)))


def _launch_state(device, stream: int, B: int, T: int, H: int, Hkv: int,
                  dh: int) -> tuple:
    """(n_split, chunks_per_split, scratch pointer, tickets pointer, scratch,
    tickets) of one shape on one stream, made at its first call: the f32
    chunk records and the B * Hkv int32 ticket counters (zeroed once; every
    kernel leaves them zero) are reused by each later call, which the
    stream orders after the one before. A decode loop's calls so cost one
    dict lookup here, and no allocation or fill."""
    key = (device.index, stream, B, T, H, Hkv, dh)
    st = _STATE.get(key)
    if st is None:
        plan = plan_splits(B, Hkv, T, H // Hkv, dh,
                           torch.cuda.get_device_properties(
                               device).multi_processor_count)
        part = torch.empty(plan.scratch_shape, dtype=torch.float32,
                           device=device)
        tickets = torch.zeros(B * Hkv, dtype=torch.int32, device=device)
        st = _STATE[key] = (plan.n_split, plan.chunks_per_split,
                            part.data_ptr(), tickets.data_ptr(), part,
                            tickets)
    return st


def lengths(kv_len, B: int, T: int, device):
    """[B] int32 valid lengths from None (whole cache), a scalar or a [B]
    vector, clamped to T. A python int is filled on the device, with no
    host-to-device copy."""
    if kv_len is None or isinstance(kv_len, int):
        n = T if kv_len is None else min(kv_len, T)
        return torch.full((B,), n, dtype=torch.int32, device=device)
    lens = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return torch.clamp(lens.expand(B), max=T).contiguous()


def cost(q_shape, kv_shape, q_dtype=torch.bfloat16, kv_dtype=None,
         kv_len=None, quantized: bool = False):
    """(flops, bytes) of one call: 4 * dh operations a (head, key) pair over
    the cache rows the lengths reach, the rows of k and v read once (int8
    with their f32 scales where ``quantized``), q read and the output
    written once. A length known on the host (None: the whole cache; a
    python int) gives the rows; a tensor of lengths is not read, so every
    row of the cache counts, on the card as on the meta device."""
    B, _, H, dh = q_shape
    T, Hkv = kv_shape[1], kv_shape[2]
    rows = T if not isinstance(kv_len, int) else max(0, min(kv_len, T))
    nbytes = (2 * B * H * dh * q_dtype.itemsize
              + 2 * B * rows * Hkv * dh * (kv_dtype or q_dtype).itemsize)
    if quantized:
        nbytes += 2 * B * rows * 4
    return 4 * B * H * rows * dh, nbytes


def decode_attention_plain(q, k, v, lens, k_scale=None, v_scale=None):
    """Plain version: grouped single-query attention in f32 over the first
    ``lens[b]`` cache positions of each row; a row with no valid position
    returns 0, as the kernel does."""
    B, _, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, None, None]
        vf = vf * v_scale[:, :, None, None]
    qg = q[:, 0].float().reshape(B, Hkv, H // Hkv, dh) * (1.0 / dh ** 0.5)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kf)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, vf)
    out = torch.where((lens > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def decode_attention(q, k, v, *, kv_len=None, k_scale=None, v_scale=None):
    """q: [B, 1, H, dh]; k/v: [B, T, Hkv, dh] -> [B, 1, H, dh] (q's dtype).

    ``kv_len``: None, a scalar or a per-row [B] vector, clamped to T.
    ``k_scale``/``v_scale``: per-(row, position) [B, T] f32 dequant scales
    of an int8 cache (both or neither).
    """
    B, S, H, dh = q.shape
    if S != 1:
        raise ValueError(f"decode_attention is single-query; got S={S}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != dh:
        raise ValueError(f"want k/v [B,T,Hkv,dh] matching q {tuple(q.shape)}"
                         f"; got {tuple(k.shape)}, {tuple(v.shape)}")
    T, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None:
        k_scale = k_scale.float().expand(B, T).contiguous()
        v_scale = v_scale.float().expand(B, T).contiguous()
    target = _B.device_kind(q.device, "decode_attention")
    if target == "cpu":
        return decode_attention_plain(
            q, k, v, lengths(kv_len, B, T, q.device), k_scale, v_scale)
    if target != "cuda":
        raise ValueError(f"decode_attention: tensor on {q.device}")
    if q.dtype not in _Q_DTYPE or k.dtype not in _KV_DTYPE \
            or v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes q float32/bfloat16 and a "
                        f"float32/bfloat16/int8 cache; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k and v must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must be 16-byte aligned")
    G = H // Hkv
    if dh not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {dh} (instances: "
                         f"{HEAD_DIMS}) or group {G} (at most {MAX_GROUP}) "
                         f"is not compiled; see ROADMAP.md, queue B")
    # a scalar length goes by value; a vector by pointer (clamped in-kernel)
    lens, len_all = None, T
    if isinstance(kv_len, int):
        len_all = max(0, min(kv_len, T))
    elif kv_len is not None:
        lens = kv_len
        if not (torch.is_tensor(lens) and lens.dtype == torch.int32
                and lens.device == q.device and lens.shape == (B,)
                and lens.is_contiguous()):
            lens = lengths(kv_len, B, T, q.device)
    out = torch.empty_like(q)
    _B.record_cost("decode_attention", *cost(
        q.shape, k.shape, q.dtype, k.dtype, kv_len, k_scale is not None))
    if q.device.type == "meta":
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, cps, part, tickets = _launch_state(q.device, stream, B, T, H,
                                                Hkv, dh)[:4]
    lib = _B.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        None if lens is None else lens.data_ptr(), len_all, out.data_ptr(),
        part, tickets, _Q_DTYPE[q.dtype], _KV_DTYPE[k.dtype], B, T, H, Hkv,
        dh, n_split, cps, stream)
    _B.check(err, "decode_attention")
    _B.count_launch(decode_attention)
    return out


decode_attention.launches = 0
