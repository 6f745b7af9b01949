"""Zamba2-style hybrid (arXiv:2411.15242): ``repro.models.hybrid``'s port.

A mamba2 backbone and ONE shared attention block, applied after every
``cfg.hybrid_attn_every`` mamba layers. The shared block takes
concat(hidden, the token embedding) down to d_model, then attention and a
SwiGLU MLP (Zamba's concatenated residual); ``repro`` leaves out the
per-application LoRA deltas, and so does the port. Each application of the
block has its own KV cache. On the card its prefill runs B2 and its decode
B3, through ``attn_backend``, as every attention layer's does.

Layout: G = n_layers // every groups of ``every`` mamba layers, each
followed by the shared block, then ``tail`` mamba layers. The params are
``repro``'s tree, so ``convert.params_from_jax`` is a checked copy:
``mamba_g`` (leaves [G, every, ...]), ``mamba_t`` (leaves [max(tail, 1),
...]: at tail 0 ``repro`` keeps one tail layer that nothing runs, and the
port keeps it, unused, too), ``shared`` (``in_proj`` [2D, D], ``attn``,
``mlp``, two norms), ``embed`` (the tied unembedding) and ``norm_f``.
``repro`` scans both levels; the port loops over them.

``HybridCache`` is flat: the mamba layers' states, one stack over the
n_layers layers in ``repro``'s order (group g's layer j at g * every + j,
then the tail), the shared block's K/V [G, B, T, Hkv, dh] (one slot of the
first dim an application) and one per-row ``pos`` [B]. A decode step
writes all of it in place, as ``transformer.decode_step`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import mamba2 as M2
from .layers import dense_init, embed_init, rmsnorm, swiglu
from .transformer import _stack, unbind_layers

__all__ = ["HybridCache", "init", "forward", "unembed", "init_cache",
           "decode_step"]


class HybridCache(NamedTuple):
    h: torch.Tensor        # [n_layers, B, H, P, N] f32: the mamba layers
    conv: torch.Tensor     # [n_layers, B, d_conv - 1, d_inner]
    conv_bc: torch.Tensor  # [n_layers, B, d_conv - 1, 2 * G * N]
    k: torch.Tensor        # [G, B, T, Hkv, dh]: the shared block's
    v: torch.Tensor        # applications
    pos: torch.Tensor      # [B] int32
    k_scale: Optional[torch.Tensor] = None  # int8 KV: [G, B, T] f32
    v_scale: Optional[torch.Tensor] = None


def _split(cfg):
    every = cfg.hybrid_attn_every
    G = cfg.n_layers // every
    return every, G, cfg.n_layers - G * every


def init(cfg, generator, device=None):
    """Seeded init with ``repro``'s distributions (``transformer.init``'s)."""
    every, G, tail = _split(cfg)
    dt = getattr(torch, cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def mamba(lead):
        return {"norm": ones(*lead, D),
                "ssm": M2.mamba2_init(generator, cfg, device=device,
                                      lead=lead)}

    def dense(*shape):
        return dense_init(generator, shape, dt, device=device)

    return {
        "embed": embed_init(generator, (cfg.vocab, D), dt, device=device),
        "mamba_g": mamba((G, every)),
        "mamba_t": mamba((max(tail, 1),)),
        "shared": {
            "in_proj": dense(2 * D, D),
            "norm_attn": ones(D),
            "attn": A.attn_init(generator, cfg, device=device),
            "norm_ffn": ones(D),
            "mlp": {"w_gate": dense(D, F), "w_up": dense(D, F),
                    "w_down": dense(F, D)},
        },
        "norm_f": ones(D),
    }


def _ssm_view(c, i: int) -> M2.SSMCache:
    return M2.SSMCache(h=c.h[i], conv=c.conv[i], conv_bc=c.conv_bc[i],
                       pos=c.pos)


def _kv_view(c, g: int) -> A.KVCache:
    return A.KVCache(k=c.k[g], v=c.v[g], pos=c.pos,
                     k_scale=None if c.k_scale is None else c.k_scale[g],
                     v_scale=None if c.v_scale is None else c.v_scale[g])


def _shared_in(sp, h, h0, cfg):
    """The shared block's input: (x = concat(h, h0) @ in_proj, its norm)."""
    x = torch.cat([h, h0], dim=-1) @ sp["in_proj"]
    return x, rmsnorm(x, sp["norm_attn"], cfg.norm_eps)


def _shared_out(sp, h, x, attn_out, cfg):
    x = x + attn_out
    x = x + swiglu(rmsnorm(x, sp["norm_ffn"], cfg.norm_eps), **sp["mlp"])
    return h + x


def _layers(p, cfg):
    """The mamba layers' param views in cache order, each with the shared
    block's application that follows it (or None)."""
    every, G, tail = _split(cfg)
    out = []
    for g, gp in enumerate(unbind_layers(p["mamba_g"], G)):
        for j, lp in enumerate(unbind_layers(gp, every)):
            out.append((lp, g if j == every - 1 else None))
    if tail:
        out += [(lp, None) for lp in unbind_layers(p["mamba_t"], tail)]
    return out


def forward(p, cfg, batch, *, window="cfg", make_cache=False,
            cache_len=None, out=None):
    """Forward over ``batch["tokens"]`` [B, S] -> (final normed hidden
    [B, S, D], a ``HybridCache`` or None, a 0-d f32 zero: the family has no
    auxiliary loss). ``out``: a ``HybridCache`` to write the caches into
    (and return) with ``make_cache``. Under autograd ``cfg.remat``
    recomputes each mamba layer in the backward, as ``repro``
    checkpoints its inner scan's body."""
    h = p["embed"][batch["tokens"]].to(getattr(torch, cfg.compute_dtype))
    h0 = h
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    rot = A.rotary(cfg, positions)
    sp = p["shared"]
    remat = cfg.remat and not make_cache and torch.is_grad_enabled()
    m_caches, a_caches = [], []

    def mamba(h, lp, i):
        o, c = M2.mamba2_forward(
            lp["ssm"], rmsnorm(h, lp["norm"], cfg.norm_eps), cfg,
            make_cache=make_cache,
            out=None if out is None else _ssm_view(out, i))
        if make_cache and out is None:
            m_caches.append(c)
        return h + o

    for i, (lp, g) in enumerate(_layers(p, cfg)):
        h = checkpoint(mamba, h, lp, i, use_reentrant=False,
                       preserve_rng_state=False) if remat \
            else mamba(h, lp, i)
        if g is None:
            continue
        x, xn = _shared_in(sp, h, h0, cfg)
        attn_out, c = A.attn_forward(
            sp["attn"], xn, cfg, positions=positions, window=window,
            make_cache=make_cache, cache_len=cache_len, rot=rot,
            out=None if out is None else _kv_view(out, g))
        if make_cache and out is None:
            a_caches.append(c)
        h = _shared_out(sp, h, x, attn_out, cfg)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if not make_cache:
        return h, None, zero
    if out is None:
        m, kv = _stack(m_caches), _stack(a_caches)
        out = HybridCache(h=m.h, conv=m.conv, conv_bc=m.conv_bc, k=kv.k,
                          v=kv.v, pos=kv.pos, k_scale=kv.k_scale,
                          v_scale=kv.v_scale)
    return h, out, zero


def unembed(p, h):
    """Logits through the tied embedding: h [..., D] @ embed.T."""
    return h @ p["embed"].t()


def init_cache(cfg, batch_size: int, max_len: int, window="cfg",
               device=None) -> HybridCache:
    """Zeroed caches: the mamba states [n_layers, B, ...] and the shared
    block's K/V [G, B, T, Hkv, dh] (a ring of the window's slots)."""
    G = _split(cfg)[1]
    window = cfg.sliding_window if window == "cfg" else window
    m = M2.init_cache(cfg, batch_size, cfg.n_layers, device=device)
    a = A.init_cache(cfg, batch_size, max_len, window=window, device=device)

    def st(x):
        return None if x is None else x.new_zeros((G,) + x.shape)

    return HybridCache(h=m.h, conv=m.conv, conv_bc=m.conv_bc, k=st(a.k),
                       v=st(a.v), pos=m.pos, k_scale=st(a.k_scale),
                       v_scale=st(a.v_scale))


def decode_step(p, cfg, caches: HybridCache, token, *, window="cfg"):
    """One decode step. token [B] int; ``caches.pos`` [B] int32 (a scalar
    broadcasts). Every mamba layer's state and conv tails and every
    application's K/V row are written into ``caches`` in place. Returns
    (logits [B, V], caches with ``pos + 1``, a new tensor)."""
    window = cfg.sliding_window if window == "cfg" else window
    pos = A.row_pos(caches.pos, token.shape[0], token.device)
    at = A.decode_at(cfg, pos, caches.k.shape[2], window)
    h = p["embed"][token[:, None]].to(getattr(torch, cfg.compute_dtype))
    h0 = h
    sp = p["shared"]
    for i, (lp, g) in enumerate(_layers(p, cfg)):
        h = h + M2.decode_layer(
            lp["ssm"], rmsnorm(h, lp["norm"], cfg.norm_eps), cfg,
            caches.h[i], caches.conv[i], caches.conv_bc[i])
        if g is None:
            continue
        x, xn = _shared_in(sp, h, h0, cfg)
        kv = _kv_view(caches, g)
        attn_out = A.decode_layer(sp["attn"], xn, cfg, kv.k, kv.v,
                                  kv.k_scale, kv.v_scale, at)
        h = _shared_out(sp, h, x, attn_out, cfg)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    return unembed(p, h)[:, 0], caches._replace(pos=pos + 1)
