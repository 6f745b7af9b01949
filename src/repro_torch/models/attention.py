"""GQA attention: the plain chunked path, the KV cache and cached decode.

The chunked ``mha`` is the ``"torch"`` attention backend: queries are
processed in blocks of ``cfg.attn_chunk`` so scores never exist at
[B, H, S, S], GQA is computed grouped (query head h reads kv head
h // (H / Hkv); K/V are never repeated), and it is the only path with
sliding-window masking. ``attn_forward`` / ``attn_decode`` route through
``models/attn_backend.py``, which sends supported calls to the CUDA
kernels (``kernels/flash_attention``, ``kernels/decode_attention``).

The cache is written in place (``attn_decode`` stores the new K/V row
into the cache tensors it was given) where ``repro`` returned an updated
copy: the serving loop never needs the old cache, and a copy per step
would move the whole cache. ``KVCache.pos`` is a per-row ``[B]`` int32
tensor on the cache's device (``repro``'s ``vectorize_pos`` form): each
row writes its own slot and masks to its own length, and nothing in a
decode step reads a position on the host, so a CUDA graph can capture
the step. The positions advance functionally (``pos + 1``, a new tensor).

Cross attention (the encdec family's decoder) takes its K/V from another
sequence, ``kv_x`` of :func:`attn_forward`: its cache is the K/V over the
encoder output, fixed for the whole decode, read by
:func:`cross_attn_decode` with no length mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .layers import _dot, apply_rope, dense_init, rmsnorm, rope_tables

NEG_INF = -1e30

# KV-cache storage dtypes: quantization is write-side only; dequantization
# happens at read time (inside the decode kernel on the flash backend).
KV_DTYPES = ("float32", "bfloat16", "int8")


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, T, Hkv, dh] ([L, B, T, Hkv, dh] when stacked)
    v: torch.Tensor
    pos: torch.Tensor  # [B] int32: tokens written to each row
    # int8 KV only: per-(row, position) f32 dequant scales [B, T]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def kv_dtype(cfg) -> torch.dtype:
    """The cache storage dtype: ``cfg.kv_dtype`` or compute_dtype."""
    return getattr(torch, cfg.kv_dtype or cfg.compute_dtype)


def quantize_kv(x, dt):
    """Quantize fresh K/V rows ``[B, S, Hkv, dh]`` for cache storage.

    int8 uses a symmetric per-(row, position) scale over the [Hkv, dh]
    tail, computed once at write time; any other dtype is a plain cast
    with ``scale=None``. Returns ``(stored, scale)``.
    """
    if dt == torch.int8:
        s = torch.amax(torch.abs(x), dim=(2, 3)).float() / 127.0
        s = torch.clamp_min(s, 1e-8)  # all-zero rows (padding) stay zero
        q = torch.round(x.float() / s[:, :, None, None])
        return torch.clamp(q, -127.0, 127.0).to(torch.int8), s
    return x.to(dt), None


def attn_init(generator, cfg, device=None, n_layers: Optional[int] = None):
    """Attention params; with ``n_layers`` every leaf gets a leading [L]."""
    d, dh = cfg.d_model, cfg.head_dim
    lead = () if n_layers is None else (n_layers,)
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "wq": dense_init(generator, lead + (d, cfg.n_heads, dh), dt,
                         fan_in=d, device=device),
        "wk": dense_init(generator, lead + (d, cfg.n_kv_heads, dh), dt,
                         fan_in=d, device=device),
        "wv": dense_init(generator, lead + (d, cfg.n_kv_heads, dh), dt,
                         fan_in=d, device=device),
        "wo": dense_init(generator, lead + (cfg.n_heads, dh, d), dt,
                         fan_in=cfg.n_heads * dh, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (dh,), dtype=dt, device=device)
        p["k_norm"] = torch.ones(lead + (dh,), dtype=dt, device=device)
    return p


def _proj(x, w3):
    """[B,S,D] @ [D,H,dh] -> [B,S,H,dh] (through the robust-backward-aware
    ``_dot``)."""
    D, H, dh = w3.shape
    return _dot(x, w3.reshape(D, H * dh)).reshape(x.shape[:-1] + (H, dh))


def _out_proj(out, wo):
    """[B,S,H,dh] @ [H,dh,D] -> [B,S,D] (through ``_dot``)."""
    H, dh, D = wo.shape
    return _dot(out.reshape(out.shape[:2] + (H * dh,)),
                wo.reshape(H * dh, D))


def rotary(cfg, positions):
    """The rotary (cos, sin) tables at ``positions`` [B, S], or None for a
    config without RoPE (or no positions): made once and passed to every
    layer."""
    if not cfg.rope or positions is None:
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _query(p, x, cfg):
    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _qkv(p, x, cfg, rot):
    q = _query(p, x, cfg)
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rot is not None:
        q = apply_rope(q, *rot)
        k = apply_rope(k, *rot)
    return q, k, v


def mha(q, k, v, *, causal: bool, window: Optional[int], chunk: int,
        q_offset: int = 0, kv_len=None):
    """Chunked grouped multi-head attention (the plain backend).

    q: [B, S, H, dh]; k/v: [B, T, Hkv, dh]. ``q_offset``: absolute position
    of q[0] relative to k[0]. ``kv_len``: optional valid kv length, a
    scalar or a per-row [B] tensor. Scores are taken in q's dtype and
    softmaxed in f32, the probabilities cast back to q's dtype — the
    arithmetic of ``repro``'s ``mha``. Returns [B, S, H, dh].
    """
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if k.dtype != q.dtype:
        # a narrower cache (bf16 under an f32 model) upcasts exactly, as
        # JAX's type promotion does inside its einsums
        k, v = k.to(q.dtype), v.to(q.dtype)
    # filled on the device: no host-to-device copy in a captured step
    scale = 1.0 / torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                        device=q.device)).to(q.dtype)
    kv_pos = torch.arange(T, device=q.device)
    row_valid = None
    if torch.is_tensor(kv_len) and kv_len.ndim > 0:
        row_valid = kv_pos[None, :] < kv_len[:, None]  # [B, T]
    outs = []
    for c0 in range(0, S, chunk):
        qc = q[:, c0:c0 + chunk]
        n = qc.shape[1]
        q_pos = q_offset + c0 + torch.arange(n, device=q.device)
        qg = (qc * scale).reshape(B, n, Hkv, G, dh)
        s = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
        mask = torch.ones((n, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None and row_valid is None:
            mask &= kv_pos[None, :] < kv_len
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        if row_valid is not None:
            s = torch.where(row_valid[:, None, None, None, :], s,
                            torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgst,bthd->bshgd", p, v
                                 ).reshape(B, n, H, dh))
    return torch.cat(outs, dim=1)


def attn_forward(p, x, cfg, *, positions, causal=True, window="cfg",
                 kv_x=None, make_cache=False, cache_len=None, rot=None,
                 out=None):
    """Full-sequence attention (prefill, an encoder, cross attention).
    Returns (out [B,S,D], cache or None). ``window`` overrides
    cfg.sliding_window when given; ``rot``: the forward's :func:`rotary`
    tables (else made from ``positions``); ``kv_x`` [B, F, D]: the sequence
    K/V come from (cross attention, no rotary), whose cache is
    :func:`make_cross_cache`'s K/V, the very tensors this call attended
    over (``repro`` projects them once more for its cache), never padded
    or quantised; ``out``: a cache of the shape made here to copy the
    cache into and return in its place (a None field of ``out`` is not
    written)."""
    from . import attn_backend as AB

    window = cfg.sliding_window if window == "cfg" else window
    if kv_x is not None:
        q, cross = _query(p, x, cfg), make_cross_cache(p, kv_x, cfg)
        k, v = cross.k, cross.v
    else:
        q, k, v = _qkv(p, x, cfg, rot if rot is not None
                       else rotary(cfg, positions))
    o = _out_proj(AB.full_attention(q, k, v, cfg, causal=causal,
                                    window=window), p["wo"])
    cache = None
    if make_cache and kv_x is not None:
        cache = _copy_out(cross, out)
    elif make_cache:
        S = k.shape[1]
        if window:
            # ring cache of `window` slots: position p lives at p % window
            w = window
            if S >= w:
                ck = torch.roll(k[:, -w:], S % w, dims=1)
                cv = torch.roll(v[:, -w:], S % w, dims=1)
            else:
                ck, cv = _pad_time(k, w), _pad_time(v, w)
        else:
            T = cache_len or S
            ck, cv = (_pad_time(k, T), _pad_time(v, T)) if T >= S \
                else (k[:, :T], v[:, :T])
        dt = kv_dtype(cfg)
        ck, ks = quantize_kv(ck, dt)
        cv, vs = quantize_kv(cv, dt)
        pos = torch.full((k.shape[0],), S, dtype=torch.int32,
                         device=k.device)
        cache = _copy_out(KVCache(k=ck.contiguous(), v=cv.contiguous(),
                                  pos=pos, k_scale=ks, v_scale=vs), out)
    return o, cache


def _copy_out(cache, out):
    """``cache`` copied into ``out``'s tensors (its None fields skipped) and
    ``out`` returned; ``cache`` itself when ``out`` is None."""
    if out is None:
        return cache
    for dst, src in zip(out, cache):
        if dst is not None:
            dst.copy_(src)
    return out


def make_cross_cache(p, enc_out, cfg) -> KVCache:
    """The K/V of cross attention over ``enc_out`` [B, F, D] (k normed
    under ``qk_norm``), kept in the compute dtype for every decode step;
    ``pos`` [B] is F."""
    k = _proj(enc_out, p["wk"])
    v = _proj(enc_out, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return KVCache(k=k, v=v, pos=torch.full(
        (k.shape[0],), k.shape[1], dtype=torch.int32, device=k.device))


def cross_attn_decode(p, x1, cfg, cross: KVCache):
    """Decode-time cross attention of x1 [B, 1, D] over the whole fixed
    cache ``cross`` [B, F, Hkv, dh]: B3 with the python-int length F, so no
    length tensor is made and the call captures. Returns [B, 1, D]."""
    from . import attn_backend as AB

    q = _query(p, x1, cfg)
    out = AB.decode_attention(q, cross.k, cross.v, cfg,
                              kv_len=cross.k.shape[1])
    return _out_proj(out, p["wo"])


def _pad_time(x, T):
    S = x.shape[1]
    if S == T:
        return x
    out = x.new_zeros((x.shape[0], T) + x.shape[2:])
    out[:, :S] = x
    return out


def init_cache(cfg, batch: int, max_len: int, window: Optional[int] = None,
               device=None):
    """Empty KV cache; with a window the cache is a ring of that size."""
    T = min(window, max_len) if window else max_len
    dt = kv_dtype(cfg)
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    ks = vs = None
    if dt == torch.int8:
        ks = torch.zeros((batch, T), dtype=torch.float32, device=device)
        vs = torch.zeros((batch, T), dtype=torch.float32, device=device)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   k_scale=ks, v_scale=vs)


def row_pos(pos, B: int, device) -> torch.Tensor:
    """``pos`` as a [B] int32 tensor on ``device``: a python int or a 0-d
    tensor broadcasts (filled on the device, no host-to-device copy)."""
    if not torch.is_tensor(pos):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    pos = pos.to(device=device, dtype=torch.int32)
    if pos.ndim == 0:
        return pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"pos of shape {tuple(pos.shape)} for {B} rows")
    return pos


class DecodeAt(NamedTuple):
    """What one decode step derives from the rows' positions, once for
    every layer (``decode_at``)."""

    rot: Optional[tuple]   # rotary (cos, sin) [B, 1, 1, dh/2], or None
    index: torch.Tensor    # [B] int64: row * T + slot, the flat cache row
    kv_len: torch.Tensor   # [B] int32: valid cache length after the write


def decode_at(cfg, pos, T: int, window) -> DecodeAt:
    """Per-row slots and lengths of a decode step at ``pos`` [B] int32 over
    caches of T slots. A ring cache (``window``) puts position p at p % T
    and is whole once p >= T; a linear cache writes slot min(p, T - 1) and
    holds p + 1 positions."""
    B = pos.shape[0]
    if window:
        slot = torch.remainder(pos, T)
        kv_len = torch.clamp(pos + 1, max=T)
    else:
        slot = torch.clamp(pos, max=T - 1)
        kv_len = pos + 1
    index = torch.arange(B, device=pos.device) * T + slot
    return DecodeAt(rotary(cfg, pos[:, None]), index, kv_len)


def _write_rows(cache, index, rows):
    """Store ``rows`` [B, ...] at the flat rows ``index`` of ``cache``
    [B, T, ...] in place (an indexed write on the device)."""
    cache.view((-1,) + cache.shape[2:]).index_copy_(0, index, rows)


def decode_layer(p, x1, cfg, k_cache, v_cache, k_scale, v_scale,
                 at: DecodeAt):
    """One layer of a decode step at ``at``: writes the new K/V row (and
    int8 scales) of each row into the caches in place; returns
    out [B, 1, D]."""
    from . import attn_backend as AB

    q, k, v = _qkv(p, x1, cfg, at.rot)
    k, ks1 = quantize_kv(k, k_cache.dtype)
    v, vs1 = quantize_kv(v, v_cache.dtype)
    _write_rows(k_cache, at.index, k[:, 0])
    _write_rows(v_cache, at.index, v[:, 0])
    if ks1 is not None:
        _write_rows(k_scale, at.index, ks1[:, 0])
        _write_rows(v_scale, at.index, vs1[:, 0])
    out = AB.decode_attention(q, k_cache, v_cache, cfg, kv_len=at.kv_len,
                              k_scale=k_scale, v_scale=v_scale)
    return _out_proj(out, p["wo"])


def attn_decode(p, x1, cfg, cache: KVCache, *, window="cfg"):
    """Single-token decode. x1: [B, 1, D]. ``cache.pos`` is a per-row [B]
    vector (a scalar broadcasts): each row writes its K/V at its own slot
    and attends to its own length. Writes into ``cache`` in place; returns
    (out [B, 1, D], cache with ``pos + 1``)."""
    window = cfg.sliding_window if window == "cfg" else window
    pos = row_pos(cache.pos, x1.shape[0], x1.device)
    at = decode_at(cfg, pos, cache.k.shape[1], window)
    out = decode_layer(p, x1, cfg, cache.k, cache.v, cache.k_scale,
                       cache.v_scale, at)
    return out, cache._replace(pos=pos + 1)
