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
would move the whole cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .layers import dense_init, rmsnorm, rope

NEG_INF = -1e30

# KV-cache storage dtypes: quantization is write-side only; dequantization
# happens at read time (inside the decode kernel on the flash backend).
KV_DTYPES = ("float32", "bfloat16", "int8")


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, T, Hkv, dh] ([L, B, T, Hkv, dh] when stacked)
    v: torch.Tensor
    pos: int  # tokens already written (every row at the same position)
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
    """[B,S,D] @ [D,H,dh] -> [B,S,H,dh]."""
    D, H, dh = w3.shape
    return (x @ w3.reshape(D, H * dh)).reshape(x.shape[:-1] + (H, dh))


def _out_proj(out, wo):
    """[B,S,H,dh] @ [H,dh,D] -> [B,S,D]."""
    H, dh, D = wo.shape
    return out.reshape(out.shape[:2] + (H * dh,)) @ wo.reshape(H * dh, D)


def _qkv(p, x, cfg, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
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
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), device=q.device)
                             ).to(q.dtype)
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
                 make_cache=False, cache_len=None):
    """Full-sequence attention (prefill). Returns (out [B,S,D], cache or
    None). ``window`` overrides cfg.sliding_window when given."""
    from . import attn_backend as AB

    window = cfg.sliding_window if window == "cfg" else window
    q, k, v = _qkv(p, x, cfg, positions)
    out = AB.full_attention(q, k, v, cfg, causal=causal, window=window)
    out = _out_proj(out, p["wo"])
    cache = None
    if make_cache:
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
        cache = KVCache(k=ck.contiguous(), v=cv.contiguous(), pos=S,
                        k_scale=ks, v_scale=vs)
    return out, cache


def _pad_time(x, T):
    S = x.shape[1]
    if S == T:
        return x
    pad = torch.zeros((x.shape[0], T - S) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


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
                   v=torch.zeros(shape, dtype=dt, device=device), pos=0,
                   k_scale=ks, v_scale=vs)


def attn_decode(p, x1, cfg, cache: KVCache, *, window="cfg"):
    """Single-token decode. x1: [B, 1, D]. Writes the new K/V row into
    ``cache`` in place; returns (out [B, 1, D], cache advanced by one)."""
    from . import attn_backend as AB

    window = cfg.sliding_window if window == "cfg" else window
    pos = cache.pos
    B = x1.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x1.device)
    q, k, v = _qkv(p, x1, cfg, positions)
    T = cache.k.shape[1]
    slot = pos % T if window else min(pos, T - 1)
    k, ks1 = quantize_kv(k, cache.k.dtype)
    v, vs1 = quantize_kv(v, cache.v.dtype)
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    if ks1 is not None:
        cache.k_scale[:, slot] = ks1[:, 0]
        cache.v_scale[:, slot] = vs1[:, 0]
    # ring: all T slots valid once pos >= T; linear: the first pos+1 slots
    kv_len = min(pos + 1, T) if window else pos + 1
    out = AB.decode_attention(q, cache.k, cache.v, cfg, kv_len=kv_len,
                              k_scale=cache.k_scale, v_scale=cache.v_scale)
    return _out_proj(out, p["wo"]), cache._replace(pos=pos + 1)
