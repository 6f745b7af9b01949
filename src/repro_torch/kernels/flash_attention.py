"""Flash-attention forward kernel B2 (full-sequence: prefill, training).

``flash_attention`` replaces ``repro.kernels.flash_attention.flash_attention``
(Pallas call ``_flash_bh``, l.76/108). The CUDA kernel
(``csrc/flash_attention.cu``) keeps the online-softmax state in f32
registers, so scores never reach device memory, and GQA stays grouped
(K/V are read at kv head h // (H / Hkv), never repeated). For bf16 it runs
one warpgroup per 64-row query tile and computes Q.K^T and P.V on the
tensor cores (``wgmma``), with K/V tiles double-buffered in shared memory;
f32 inputs take a CUDA-core body. At the prefill shapes it moves ~9.4 MB
per layer, so the H100 bound is bandwidth.

The wrapper launches the kernel for CUDA tensors (f32 or bf16, dh in
``HEAD_DIMS``, contiguous), raises on anything else, and counts launches
in ``flash_attention.launches`` (eager ones: ``build.count_launch``); for
CPU tensors it runs ``flash_attention_plain``. Dispatch policy lives in
``models/attn_backend.py``.
"""
from __future__ import annotations

import torch

from . import build as _B

__all__ = ["flash_attention", "flash_attention_plain", "cost", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 96, 112, 128)  # the instances csrc compiles
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "flash_attention_fwd": [_B.P, _B.P, _B.P, _B.P, _B.I, _B.I, _B.I, _B.I,
                            _B.I, _B.I, _B.I, _B.I, _B.P],
}
NEG_INF = -1e30


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,dh], k/v [B,T,Hkv,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if H % k.shape[2]:
        raise ValueError(f"H={H} not a multiple of Hkv={k.shape[2]}")


def cost(q_shape, kv_shape, dtype=torch.bfloat16, *, causal: bool = True):
    """(flops, bytes) of one call: the two products, 2 * dh operations a
    (query, key, head) pair each, over every pair (half of them when
    causal with S = T); q, k and v read once and the output written once
    (PERF.md's bound)."""
    B, S, H, dh = q_shape
    T, Hkv = kv_shape[1], kv_shape[2]
    flops = 4 * B * H * S * T * dh
    if causal and S == T:
        flops //= 2
    return flops, dtype.itemsize * (2 * B * S * H * dh + 2 * B * T * Hkv * dh)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain version: grouped softmax attention in f32, q's dtype out."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, dh)
    s = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) * (1.0 / dh ** 0.5)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, S, H, dh]; k/v: [B, T, Hkv, dh] -> [B, S, H, dh] (q's dtype).

    The causal mask is ``k_pos <= q_pos`` with no offset; T may differ
    from S (ragged key lengths are masked in-kernel)."""
    _check_shapes(q, k, v)
    target = _B.device_kind(q.device, "flash_attention")
    if target == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if target != "cuda":
        raise ValueError(f"flash_attention: tensor on {q.device}")
    if q.dtype not in _DTYPE_ID or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q/k/v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    B, S, H, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} is not compiled "
                         f"(instances: {HEAD_DIMS}; see ROADMAP.md, queue "
                         f"B)")
    out = torch.empty_like(q)
    _B.record_cost("flash_attention", *cost(q.shape, k.shape, q.dtype,
                                            causal=causal))
    if q.device.type == "meta":
        return out
    lib = _B.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_ID[q.dtype], B, S, k.shape[1], H, k.shape[2], dh, int(causal),
        _B.stream_handle(q.device))
    _B.check(err, "flash_attention")
    _B.count_launch(flash_attention)
    return out


flash_attention.launches = 0
