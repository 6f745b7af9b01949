"""Whisper-style encoder-decoder (arXiv:2212.04356): ``repro.models.whisper``'s
port.

The mel-spectrogram and conv frontend are a stub: ``batch["frames"]``
holds precomputed frame embeddings [B, n_frames, D]. Sinusoidal positions
(no RoPE), pre-norm layers, SwiGLU MLPs. The encoder is non-causal
self-attention over the frames; each decoder layer runs causal
self-attention (cached), cross attention over the encoder output and the
MLP. On the card every attention of the prefill is B2 (the encoder's and
the cross attention's non-causal) and every attention of a decode step
B3 (the cross one over the whole encoder cache), through ``attn_backend``.

The params are ``repro``'s tree, so ``convert.params_from_jax`` is a
checked copy: ``embed`` (tied: the unembedding too), ``enc_layers``
(``norm_attn``, ``attn``, ``norm_ffn``, ``mlp``, each leaf [L_enc, ...]),
``dec_layers`` (``norm_self``, ``self``, ``norm_cross``, ``cross``,
``norm_ffn``, ``mlp``, [L, ...]), ``norm_enc`` and ``norm_f``. ``repro``
scans both stacks; the port loops over them.

``EncDecCache`` is flat (``repro`` nests a self and a cross ``KVCache``):
the decoder's self K/V [L, B, T, Hkv, dh] (int8 with its scales under
``kv_dtype="int8"``), the cross K/V [L, B, F, Hkv, dh] in the compute
dtype (``repro`` never quantises them) and one per-row ``pos`` [B]: the
tokens in the self cache. Frames take no self-cache position. Every
tensor keeps its row on dim 1, so the slot pool, the replica layout and
``DecodeBuffers`` walk it as any other cache (``models.caches``). A
decode step writes the self K/V in place and only reads the cross K/V.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from .layers import (dense_init, embed_init, rmsnorm, sinusoid,
                     sinusoidal_positions, swiglu)
from .transformer import _stack, unbind_layers

__all__ = ["EncDecCache", "init", "encode", "forward", "unembed",
           "init_cache", "decode_step"]


class EncDecCache(NamedTuple):
    k: torch.Tensor        # [L, B, T, Hkv, dh]: decoder self-attention
    v: torch.Tensor
    ck: torch.Tensor       # [L, B, F, Hkv, dh]: cross K/V over the encoder
    cv: torch.Tensor       # output, compute dtype
    pos: torch.Tensor      # [B] int32
    k_scale: Optional[torch.Tensor] = None  # int8 self K/V: [L, B, T] f32
    v_scale: Optional[torch.Tensor] = None


def init(cfg, generator, device=None):
    """Seeded init with ``repro``'s distributions: N(0, 1/fan_in) dense
    weights, N(0, 0.02^2) embeddings, unit norm scales."""
    dt = getattr(torch, cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def mlp(L):
        return {"w_gate": dense_init(generator, (L, D, F), dt, fan_in=D,
                                     device=device),
                "w_up": dense_init(generator, (L, D, F), dt, fan_in=D,
                                   device=device),
                "w_down": dense_init(generator, (L, F, D), dt, fan_in=F,
                                     device=device)}

    Le, L = cfg.encoder.n_layers, cfg.n_layers
    return {
        "embed": embed_init(generator, (cfg.vocab, D), dt, device=device),
        "enc_layers": {
            "norm_attn": ones(Le, D),
            "attn": A.attn_init(generator, cfg, device=device, n_layers=Le),
            "norm_ffn": ones(Le, D),
            "mlp": mlp(Le),
        },
        "dec_layers": {
            "norm_self": ones(L, D),
            "self": A.attn_init(generator, cfg, device=device, n_layers=L),
            "norm_cross": ones(L, D),
            "cross": A.attn_init(generator, cfg, device=device, n_layers=L),
            "norm_ffn": ones(L, D),
            "mlp": mlp(L),
        },
        "norm_enc": ones(D),
        "norm_f": ones(D),
    }


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _ffn(lp, h, cfg):
    return h + swiglu(rmsnorm(h, lp["norm_ffn"], cfg.norm_eps), **lp["mlp"])


def encode(p, cfg, frames):
    """frames [B, F, D] (the stub frontend's embeddings) -> the encoder
    output [B, F, D]: non-causal self-attention layers over the frames and
    their sinusoidal positions (each cast to the compute dtype, then
    added, as ``repro`` adds them)."""
    dt = getattr(torch, cfg.compute_dtype)
    h = frames.to(dt) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, dt, device=frames.device)[None]

    def layer(h, lp):
        out, _ = A.attn_forward(
            lp["attn"], rmsnorm(h, lp["norm_attn"], cfg.norm_eps), cfg,
            positions=None, causal=False, window=None)
        return _ffn(lp, h + out, cfg)

    remat = _remat(cfg)
    for lp in unbind_layers(p["enc_layers"], cfg.encoder.n_layers):
        h = checkpoint(layer, h, lp, use_reentrant=False,
                       preserve_rng_state=False) if remat else layer(h, lp)
    return rmsnorm(h, p["norm_enc"], cfg.norm_eps)


def _views(c, i: int):
    """Layer ``i``'s self and cross caches of the flat ``c`` (the cross
    view has no ``pos``: only the self cache's is written)."""
    self_kv = A.KVCache(
        k=c.k[i], v=c.v[i], pos=c.pos,
        k_scale=None if c.k_scale is None else c.k_scale[i],
        v_scale=None if c.v_scale is None else c.v_scale[i])
    return self_kv, A.KVCache(k=c.ck[i], v=c.cv[i], pos=None)


def forward(p, cfg, batch, *, window="cfg", make_cache=False,
            cache_len=None, out=None):
    """Encode ``batch["frames"]`` and run the decoder over
    ``batch["tokens"]`` [B, S] -> (final normed hidden [B, S, D], an
    ``EncDecCache`` or None, a 0-d f32 zero: the family has no auxiliary
    loss). ``window`` is ignored: the family has no sliding window
    (``repro`` runs none). ``out``: an ``EncDecCache`` to write the caches
    into (and return) with ``make_cache``. Under autograd ``cfg.remat``
    recomputes each layer of both stacks in the backward."""
    dt = getattr(torch, cfg.compute_dtype)
    enc = encode(p, cfg, batch["frames"])
    tokens = batch["tokens"]
    h = p["embed"][tokens].to(dt) + sinusoidal_positions(
        tokens.shape[1], cfg.d_model, dt, device=tokens.device)[None]
    self_c, cross_c = [], []

    def layer(h, enc, lp, i):
        so, co = (None, None) if out is None else _views(out, i)
        o, sc = A.attn_forward(
            lp["self"], rmsnorm(h, lp["norm_self"], cfg.norm_eps), cfg,
            positions=None, causal=True, window=None, make_cache=make_cache,
            cache_len=cache_len, out=so)
        h = h + o
        o, cc = A.attn_forward(
            lp["cross"], rmsnorm(h, lp["norm_cross"], cfg.norm_eps), cfg,
            positions=None, causal=False, window=None, kv_x=enc,
            make_cache=make_cache, out=co)
        if make_cache and out is None:
            self_c.append(sc)
            cross_c.append(cc)
        return _ffn(lp, h + o, cfg)

    remat = _remat(cfg) and not make_cache
    for i, lp in enumerate(unbind_layers(p["dec_layers"], cfg.n_layers)):
        h = checkpoint(layer, h, enc, lp, i, use_reentrant=False,
                       preserve_rng_state=False) if remat \
            else layer(h, enc, lp, i)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if not make_cache:
        return h, None, zero
    if out is None:
        s, c = _stack(self_c), _stack(cross_c)
        out = EncDecCache(k=s.k, v=s.v, ck=c.k, cv=c.v, pos=s.pos,
                          k_scale=s.k_scale, v_scale=s.v_scale)
    return h, out, zero


def unembed(p, h):
    """Logits through the tied embedding: h [..., D] @ embed.T."""
    return h @ p["embed"].t()


def init_cache(cfg, batch_size: int, max_len: int, window="cfg",
               device=None) -> EncDecCache:
    """Zeroed caches: the self K/V [L, B, max_len, Hkv, dh] (the family has
    no window) and the cross K/V [L, B, F, Hkv, dh] in the compute
    dtype."""
    a = A.init_cache(cfg, batch_size, max_len, device=device)
    L = cfg.n_layers

    def st(x):
        return None if x is None else x.new_zeros((L,) + x.shape)

    cross = (L, batch_size, cfg.encoder.n_frames, cfg.n_kv_heads,
             cfg.head_dim)
    dtc = getattr(torch, cfg.compute_dtype)
    return EncDecCache(k=st(a.k), v=st(a.v),
                       ck=torch.zeros(cross, dtype=dtc, device=device),
                       cv=torch.zeros(cross, dtype=dtc, device=device),
                       pos=a.pos, k_scale=st(a.k_scale),
                       v_scale=st(a.v_scale))


def decode_step(p, cfg, caches: EncDecCache, token, *, window="cfg"):
    """One decode step. token [B] int; ``caches.pos`` [B] int32 (a scalar
    broadcasts): each row's position in the self cache, whose sinusoid is
    made on the device. Each layer's new self K/V row is written into
    ``caches`` in place; the cross K/V are read whole. ``window`` is
    ignored, as in :func:`forward`. Returns (logits [B, V], caches with
    ``pos + 1``, a new tensor)."""
    dt = getattr(torch, cfg.compute_dtype)
    pos = A.row_pos(caches.pos, token.shape[0], token.device)
    at = A.decode_at(cfg, pos, caches.k.shape[2], None)
    h = p["embed"][token[:, None]].to(dt) + sinusoid(
        pos, cfg.d_model).to(dt)[:, None]
    for i, lp in enumerate(unbind_layers(p["dec_layers"], cfg.n_layers)):
        self_kv, cross = _views(caches, i)
        h = h + A.decode_layer(
            lp["self"], rmsnorm(h, lp["norm_self"], cfg.norm_eps), cfg,
            self_kv.k, self_kv.v, self_kv.k_scale, self_kv.v_scale, at)
        h = h + A.cross_attn_decode(
            lp["cross"], rmsnorm(h, lp["norm_cross"], cfg.norm_eps), cfg,
            cross)
        h = _ffn(lp, h, cfg)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    return unembed(p, h)[:, 0], caches._replace(pos=pos + 1)
