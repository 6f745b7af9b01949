"""Decode-attention kernel B3 (one query token against a KV cache).

``decode_attention`` replaces ``repro.kernels.decode_attention
.decode_attention`` (Pallas call ``_decode_grouped``, l.158/246, with both
bodies ``_kernel_narrow`` and ``_kernel_wide``). The CUDA kernel
(``csrc/decode_attention.cu``) runs one block per (kv head, batch row)
covering the whole query group, reads the cache in place (never repeated
to H heads), multiplies int8 dequant scales in at load, masks each row to
its own valid length and keeps the online softmax in f32. Decode
attention is bound by the bytes of K/V it must read on the H100; with
B * Hkv blocks the first version fills only part of the card.

The wrapper launches the kernel for CUDA tensors (q f32/bf16, cache
f32/bf16/int8, dh in {32, 64, 128}, H / Hkv <= 8, contiguous), raises on
anything else, and counts launches in ``decode_attention.launches``; for
CPU tensors it runs ``decode_attention_plain``.
"""
from __future__ import annotations

import torch

from . import build as _B

__all__ = ["decode_attention", "decode_attention_plain", "lengths",
           "HEAD_DIMS", "MAX_GROUP"]

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per kv head (kMaxGroup)
_Q_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIGNATURES = {
    "decode_attention_fwd": [_B.P, _B.P, _B.P, _B.P, _B.P, _B.P, _B.P, _B.I,
                             _B.I, _B.I, _B.I, _B.I, _B.I, _B.I, _B.P],
}
NEG_INF = -1e30


def lengths(kv_len, B: int, T: int, device):
    """[B] int32 valid lengths from None (whole cache), a scalar or a [B]
    vector, clamped to T. A python int is filled on the device, with no
    host-to-device copy."""
    if kv_len is None or isinstance(kv_len, int):
        n = T if kv_len is None else min(kv_len, T)
        return torch.full((B,), n, dtype=torch.int32, device=device)
    lens = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return torch.clamp(lens.expand(B), max=T).contiguous()


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
    lens = lengths(kv_len, B, T, q.device)
    if k_scale is not None:
        k_scale = k_scale.float().expand(B, T).contiguous()
        v_scale = v_scale.float().expand(B, T).contiguous()
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lens, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensor on {q.device}")
    if q.dtype not in _Q_DTYPE or k.dtype not in _KV_DTYPE \
            or v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes q float32/bfloat16 and a "
                        f"float32/bfloat16/int8 cache; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k and v must be contiguous")
    if dh not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {dh} (want one of "
                         f"{HEAD_DIMS}) or group {H // Hkv} (max "
                         f"{MAX_GROUP}) not compiled")
    out = torch.empty_like(q)
    lib = _B.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        lens.data_ptr(), out.data_ptr(), _Q_DTYPE[q.dtype],
        _KV_DTYPE[k.dtype], B, T, H, Hkv, dh, _B.stream_handle(q.device))
    _B.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
