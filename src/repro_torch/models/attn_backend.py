"""Backend-dispatched attention: one policy site, kernel-selected execution.

Model layers never call a kernel directly; they call
:func:`full_attention` / :func:`decode_attention` here, and the backend on
the model config (``ArchConfig.attn_backend``) decides what runs:

* ``"torch"`` — the plain chunked ``attention.mha`` (``repro``'s ``"jnp"``),
  the only backend with sliding-window masking.
* ``"flash"`` — the CUDA kernels: B2 (``kernels/flash_attention``) for
  full-sequence attention, B3 (``kernels/decode_attention``) for cached
  decode. A kernel wrapper given CPU tensors runs its plain version.
* ``"auto"``  — ``"flash"`` for decode everywhere; for full-sequence
  attention ``"flash"`` on CUDA tensors and ``"torch"`` on the CPU. On the
  card that is kernels for prefill and decode, the TPU policy of ``repro``.
  A meta tensor (``launch.op_cost.counting``) takes the count's target.

Calls the kernels cannot express (a sliding window; a query offset or a
valid-length mask on full attention) go to ``mha`` whatever the backend.

The full-sequence flash path is differentiable: under autograd it runs
:class:`FlashAttentionFn`, whose forward is B2 and whose backward is the
VJP of the chunked ``mha``, recomputed from the saved q/k/v (``repro``'s
``_flash_full``; neither package has a backward kernel).
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "torch", "flash")

__all__ = ["BACKENDS", "resolve_backend", "full_attention",
           "decode_attention", "FlashAttentionFn"]


def resolve_backend(backend: str, *, decode: bool, window=None,
                    device=None) -> str:
    """The concrete backend a call runs. ``window`` is the positional
    sliding window of a full-sequence call (decode masks by validity only,
    so ring-cache decode has none)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown attn backend {backend!r}; known: {BACKENDS}")
    if window is not None:
        return "torch"
    if backend == "auto":
        if decode:
            return "flash"
        kind = None if device is None else torch.device(device).type
        if kind == "meta":
            # a meta tensor stands for the count's target device
            from ..kernels.build import counting_target

            kind = counting_target()
        return "flash" if kind == "cuda" else "torch"
    return backend


class FlashAttentionFn(torch.autograd.Function):
    """Full-sequence attention whose forward is the flash kernel (B2; its
    plain version for CPU tensors) and whose backward recomputes the
    chunked ``mha`` from the saved q/k/v under autograd and returns its
    VJP. Inside a recomputed (checkpointed) layer the forward runs, and
    launches B2, twice."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        from ..kernels.flash_attention import flash_attention

        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad):
        from . import attention as A

        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            out = A.mha(q, k, v, causal=ctx.causal, window=None,
                        chunk=ctx.chunk)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None


def full_attention(q, k, v, cfg, *, causal, window, q_offset=0, kv_len=None):
    """Full-sequence attention [B,S,H,dh] x [B,T,Hkv,dh] -> [B,S,H,dh]."""
    from . import attention as A

    backend = cfg.attn_backend
    if q_offset != 0 or kv_len is not None:
        backend = "torch"
    if resolve_backend(backend, decode=False, window=window,
                       device=q.device) == "flash":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            # the kernel takes contiguous tensors only: made so before the
            # Function saves them for the backward
            return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                          v.contiguous(), bool(causal),
                                          cfg.attn_chunk)
        from ..kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=bool(causal))
    return A.mha(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk,
                 q_offset=q_offset, kv_len=kv_len)


def decode_attention(q, k, v, cfg, *, kv_len=None, k_scale=None,
                     v_scale=None):
    """Single-query cached attention [B,1,H,dh] x [B,T,Hkv,dh].

    ``k_scale``/``v_scale``: [B, T] f32 dequant scales of an int8 cache.
    The kernel multiplies them in at load; the plain path dequantizes
    first (to q's dtype, as ``repro`` does) and runs ``mha``.
    """
    from . import attention as A

    if resolve_backend(cfg.attn_backend, decode=True) == "flash":
        from ..kernels.decode_attention import decode_attention as _da

        return _da(q, k, v, kv_len=kv_len, k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        k = (k.float() * k_scale[:, :, None, None]).to(q.dtype)
        v = (v.float() * v_scale[:, :, None, None]).to(q.dtype)
    return A.mha(q, k, v, causal=False, window=None, chunk=1, kv_len=kv_len)
