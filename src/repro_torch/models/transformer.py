"""Decoder-only stack, dense and vlm families.

Parameters are a plain dict in ``repro``'s layout: ``embed`` [V, D]
(tied unembedding, or ``lm_head`` [D, V]), ``layers`` with every leaf
stacked [L, ...], and ``norm_f``. Where ``repro`` scans the stacked
layers with ``lax.scan``, the port loops over them in Python; caches stay
stacked [L, B, T, Hkv, dh] as in ``repro``. A vlm is the dense stack with
stub patch embeddings [B, n_patches, D] prepended to the token
embeddings; positions and the cache run over the prefix.
"""
from __future__ import annotations

import torch

from . import attention as A
from .layers import dense_init, embed_init, rmsnorm, swiglu


def layer_params(p, i: int):
    """Layer ``i``'s parameter dict (views into the stacked leaves)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


def init(cfg, generator, device=None):
    """Seeded init with ``repro``'s distributions: N(0, 1/fan_in) dense
    weights, N(0, 0.02^2) embeddings, unit norm scales."""
    dt = getattr(torch, cfg.param_dtype)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    layers = {
        "norm_attn": torch.ones((L, D), dtype=dt, device=device),
        "attn": A.attn_init(generator, cfg, device=device, n_layers=L),
        "norm_ffn": torch.ones((L, D), dtype=dt, device=device),
        "mlp": {
            "w_gate": dense_init(generator, (L, D, F), dt, fan_in=D,
                                 device=device),
            "w_up": dense_init(generator, (L, D, F), dt, fan_in=D,
                               device=device),
            "w_down": dense_init(generator, (L, F, D), dt, fan_in=F,
                                 device=device),
        },
    }
    p = {
        "embed": embed_init(generator, (cfg.vocab, D), dt, device=device),
        "layers": layers,
        "norm_f": torch.ones((D,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, (D, cfg.vocab), dt,
                                  device=device)
    return p


def _embed_tokens(p, cfg, tokens):
    return p["embed"][tokens].to(getattr(torch, cfg.compute_dtype))


def embed_inputs(p, cfg, batch):
    """tokens (+ stub patch embeddings for a vlm) -> (h [B, S, D],
    n_prefix): the patches come first, cast to the compute dtype."""
    h = _embed_tokens(p, cfg, batch["tokens"])
    n_prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(h.dtype)
        h = torch.cat([patches, h], dim=1)
        n_prefix = patches.shape[1]
    return h, n_prefix


def unembed(p, cfg, h):
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return h @ w


def _ffn(lp, h, cfg):
    hn = rmsnorm(h, lp["norm_ffn"], cfg.norm_eps)
    return h + swiglu(hn, **lp["mlp"])


def forward(p, cfg, batch, *, window="cfg", make_cache=False,
            cache_len=None, out=None):
    """Forward over ``batch`` (``tokens`` [B, S], and ``patches`` for a
    vlm). Returns (final normed hidden [B, n_prefix + S, D], stacked caches
    or None); ``unembed`` turns hidden into logits. With ``make_cache``,
    ``out`` (stacked caches [L, B, ...]) takes each layer's cache as it is
    made and is returned, where otherwise the layers' caches are stacked
    into new tensors."""
    h, _ = embed_inputs(p, cfg, batch)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    rot = A.rotary(cfg, positions)  # once for every layer
    caches = []
    for i in range(cfg.n_layers):
        lp = layer_params(p["layers"], i)
        attn_out, cache = A.attn_forward(
            lp["attn"], rmsnorm(h, lp["norm_attn"], cfg.norm_eps), cfg,
            positions=positions, window=window, make_cache=make_cache,
            cache_len=cache_len, rot=rot,
            out=None if out is None else _layer_cache(out, i))
        h = _ffn(lp, h + attn_out, cfg)
        if out is None:
            caches.append(cache)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    if not make_cache:
        return h, None
    return h, out if out is not None else _stack(caches)


def _layer_cache(caches, i: int):
    """Layer ``i``'s view of stacked caches (``pos`` is shared)."""
    return caches._replace(**{f: None if getattr(caches, f) is None
                              else getattr(caches, f)[i]
                              for f in ("k", "v", "k_scale", "v_scale")})


def _stack(caches):
    first = caches[0]

    def st(field):
        if getattr(first, field) is None:
            return None
        return torch.stack([getattr(c, field) for c in caches])

    return A.KVCache(k=st("k"), v=st("v"), pos=first.pos,
                     k_scale=st("k_scale"), v_scale=st("v_scale"))


def init_cache(cfg, batch_size: int, max_len: int, window="cfg",
               device=None):
    window = cfg.sliding_window if window == "cfg" else window
    one = A.init_cache(cfg, batch_size, max_len, window=window, device=device)

    def st(x):
        return None if x is None else \
            x[None].expand((cfg.n_layers,) + x.shape).contiguous()

    return A.KVCache(k=st(one.k), v=st(one.v), pos=one.pos,
                     k_scale=st(one.k_scale), v_scale=st(one.v_scale))


def decode_step(p, cfg, caches, token, *, window="cfg"):
    """One decode step. token: [B] int; ``caches.pos`` [B] int32 (a scalar
    broadcasts), one position a row shared by every layer. The rows' slots,
    lengths and rotary tables are made once (``attention.decode_at``) and
    read by every layer; each layer's new K/V row is written into the
    stacked ``caches`` in place. Returns (logits [B, V], caches with
    ``pos + 1``, a new tensor: the caller's ``pos`` is left as it was)."""
    window = cfg.sliding_window if window == "cfg" else window
    pos = A.row_pos(caches.pos, token.shape[0], token.device)
    at = A.decode_at(cfg, pos, caches.k.shape[2], window)
    h = _embed_tokens(p, cfg, token[:, None])
    for i in range(cfg.n_layers):
        lp = layer_params(p["layers"], i)
        attn_out = A.decode_layer(
            lp["attn"], rmsnorm(h, lp["norm_attn"], cfg.norm_eps), cfg,
            caches.k[i], caches.v[i],
            None if caches.k_scale is None else caches.k_scale[i],
            None if caches.v_scale is None else caches.v_scale[i], at)
        h = _ffn(lp, h + attn_out, cfg)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    return unembed(p, cfg, h)[:, 0], caches._replace(pos=pos + 1)
