"""Decoder-only stack, dense, vlm, moe and ssm families, and the LM loss.

Parameters are a plain dict in ``repro``'s layout: ``embed`` [V, D]
(tied unembedding, or ``lm_head`` [D, V]), ``layers`` with every leaf
stacked [L, ...], and ``norm_f``. Where ``repro`` scans the stacked
layers with ``lax.scan``, the port loops over them in Python; caches stay
stacked [L, B, T, Hkv, dh] as in ``repro``. A vlm is the dense stack with
stub patch embeddings [B, n_patches, D] prepended to the token
embeddings; positions and the cache run over the prefix. A moe layer
has ``moe`` (``models/moe.py``) in place of ``mlp``; its load-balance
loss, summed over the layers, comes out of ``forward`` and joins the LM
loss at ``repro``'s weight of 0.01 (a decode step drops it). An ssm
layer is ``norm_ssm`` and a mamba2 block ``ssm`` (``models/mamba2.py``),
with no attention and no FFN; its caches are a stacked ``SSMCache``.

Under autograd, ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``repro`` wraps its scan
body in ``jax.checkpoint``; ``cfg.remat_block`` > 1 adds ``repro``'s
second level (only every block's boundary is kept). ``chunked_ce`` never
builds [B, S, V] logits and recomputes each chunk's in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import mamba2 as M2
from . import moe as X
from .caches import map_rows, row_fields
from .layers import _dot, dense_init, embed_init, rmsnorm, swiglu


def unbind_layers(layers, n: int):
    """The stacked layer dict as ``n`` per-layer dicts of views. One
    ``unbind`` a leaf: under autograd its backward stacks the layers'
    gradients once, where indexing layer by layer would add a zero-filled
    [L, ...] tensor into the gradient for every layer."""
    per = [dict() for _ in range(n)]
    for k, v in layers.items():
        parts = unbind_layers(v, n) if isinstance(v, dict) \
            else torch.unbind(v, 0)
        for i in range(n):
            per[i][k] = parts[i]
    return per


def init(cfg, generator, device=None):
    """Seeded init with ``repro``'s distributions: N(0, 1/fan_in) dense
    weights, N(0, 0.02^2) embeddings, unit norm scales; a moe layer's
    router and experts (``moe.moe_init``) in place of its ``mlp``; an ssm
    layer's mamba2 block (``mamba2.mamba2_init``) in place of both."""
    dt = getattr(torch, cfg.param_dtype)
    L, D = cfg.n_layers, cfg.d_model
    if cfg.family == "ssm":
        layers = {"norm_ssm": torch.ones((L, D), dtype=dt, device=device),
                  "ssm": M2.mamba2_init(generator, cfg, device=device,
                                        lead=(L,))}
    else:
        layers = _attn_layers(generator, cfg, device)
    p = {
        "embed": embed_init(generator, (cfg.vocab, D), dt, device=device),
        "layers": layers,
        "norm_f": torch.ones((D,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, (D, cfg.vocab), dt,
                                  device=device)
    return p


def _attn_layers(generator, cfg, device):
    """The stacked attention layers of the dense, vlm and moe families."""
    dt = getattr(torch, cfg.param_dtype)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    layers = {
        "norm_attn": torch.ones((L, D), dtype=dt, device=device),
        "attn": A.attn_init(generator, cfg, device=device, n_layers=L),
        "norm_ffn": torch.ones((L, D), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        layers["moe"] = X.moe_init(generator, cfg, device=device, n_layers=L)
    else:
        layers["mlp"] = {
            "w_gate": dense_init(generator, (L, D, F), dt, fan_in=D,
                                 device=device),
            "w_up": dense_init(generator, (L, D, F), dt, fan_in=D,
                               device=device),
            "w_down": dense_init(generator, (L, F, D), dt, fan_in=F,
                                 device=device),
        }
    return layers


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
    """Logits of hidden ``h``; a 3-D ``h`` goes through ``_dot`` (robust
    in the backward under ``robust_backward``), tied or not."""
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    if h.ndim == 3:
        return _dot(h, w)
    return h @ w


def _ffn(lp, h, cfg):
    """The residual FFN block -> (h, aux): the moe layer's load-balance
    loss, or None for a dense layer."""
    hn = rmsnorm(h, lp["norm_ffn"], cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = X.moe_ffn(lp["moe"], hn, cfg)
        return h + out, aux
    return h + swiglu(hn, **lp["mlp"]), None


def forward(p, cfg, batch, *, window="cfg", make_cache=False,
            cache_len=None, out=None):
    """Forward over ``batch`` (``tokens`` [B, S], and ``patches`` for a
    vlm). Returns (final normed hidden [B, n_prefix + S, D], stacked caches
    or None, the moe load-balance loss summed over the layers: a 0-d f32
    tensor, 0 for the other families); ``unembed`` turns hidden into
    logits. An ssm stack's caches are an ``SSMCache``. With ``make_cache``,
    ``out`` (stacked caches [L, B, ...]) takes each layer's cache as it is
    made and is returned, where otherwise the layers' caches are stacked
    into new tensors."""
    h, _ = embed_inputs(p, cfg, batch)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    rot = A.rotary(cfg, positions)  # once for every layer
    caches = []

    def layer(h, lp, i):
        if cfg.family == "ssm":
            o, cache = M2.mamba2_forward(
                lp["ssm"], rmsnorm(h, lp["norm_ssm"], cfg.norm_eps), cfg,
                make_cache=make_cache,
                out=None if out is None else _layer_cache(out, i))
            if make_cache and out is None:
                caches.append(cache)
            return h + o
        attn_out, cache = A.attn_forward(
            lp["attn"], rmsnorm(h, lp["norm_attn"], cfg.norm_eps), cfg,
            positions=positions, window=window, make_cache=make_cache,
            cache_len=cache_len, rot=rot,
            out=None if out is None else _layer_cache(out, i))
        if make_cache and out is None:
            caches.append(cache)
        h, aux = _ffn(lp, h + attn_out, cfg)
        return h if aux is None else (h, aux)

    # repro's remat under autograd: each layer recomputed in the backward,
    # and with remat_block nb > 1 (dividing n_layers) only every nb-th
    # boundary kept, a block recomputed, then each of its layers
    remat = cfg.remat and not make_cache and torch.is_grad_enabled()

    moe = cfg.family == "moe"
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def run(h, aux, i, *lps):
        for j, lp in enumerate(lps, i):
            r = checkpoint(layer, h, lp, j, use_reentrant=False,
                           preserve_rng_state=False) if remat \
                else layer(h, lp, j)
            h, aux = (r[0], aux + r[1]) if moe else (r, aux)
        return h, aux

    lps = unbind_layers(p["layers"], cfg.n_layers)
    nb = cfg.remat_block
    if remat and nb > 1 and cfg.n_layers % nb == 0:
        for i in range(0, cfg.n_layers, nb):
            h, aux = checkpoint(run, h, aux, i, *lps[i:i + nb],
                                use_reentrant=False, preserve_rng_state=False)
    else:
        h, aux = run(h, aux, 0, *lps)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    if not make_cache:
        return h, None, aux
    return h, out if out is not None else _stack(caches), aux


def _layer_cache(caches, i: int):
    """Layer ``i``'s view of stacked caches (``pos`` is shared)."""
    return map_rows(caches, lambda x: x[i])


def _stack(caches):
    """Per-layer caches -> one stacked cache of the same type."""
    first = caches[0]
    return first._replace(**{f: torch.stack([getattr(c, f) for c in caches])
                             for f in row_fields(first)})


def init_cache(cfg, batch_size: int, max_len: int, window="cfg",
               device=None):
    """Zeroed stacked caches: an ``SSMCache`` for the ssm family, else a
    ``KVCache`` [L, B, T, Hkv, dh] (a ring of the window's slots)."""
    if cfg.family == "ssm":
        return M2.init_cache(cfg, batch_size, cfg.n_layers, device=device)
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
    ``pos + 1``, a new tensor: the caller's ``pos`` is left as it was). A
    moe layer routes each row as a group of one token; its load-balance
    loss is dropped, as ``repro`` drops it. An ssm layer writes its state
    and conv tails into the stacked ``SSMCache`` in place."""
    window = cfg.sliding_window if window == "cfg" else window
    pos = A.row_pos(caches.pos, token.shape[0], token.device)
    h = _embed_tokens(p, cfg, token[:, None])
    lps = unbind_layers(p["layers"], cfg.n_layers)
    if cfg.family == "ssm":
        for i, lp in enumerate(lps):
            h = h + M2.decode_layer(
                lp["ssm"], rmsnorm(h, lp["norm_ssm"], cfg.norm_eps), cfg,
                caches.h[i], caches.conv[i], caches.conv_bc[i])
        h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
        return unembed(p, cfg, h)[:, 0], caches._replace(pos=pos + 1)
    at = A.decode_at(cfg, pos, caches.k.shape[2], window)
    for i, lp in enumerate(lps):
        attn_out = A.decode_layer(
            lp["attn"], rmsnorm(h, lp["norm_attn"], cfg.norm_eps), cfg,
            caches.k[i], caches.v[i],
            None if caches.k_scale is None else caches.k_scale[i],
            None if caches.v_scale is None else caches.v_scale[i], at)
        h, _ = _ffn(lp, h + attn_out, cfg)
    h = rmsnorm(h, p["norm_f"], cfg.norm_eps)
    return unembed(p, cfg, h)[:, 0], caches._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_ce(p, cfg, hidden, labels, mask=None):
    """Sequence-chunked cross-entropy that never builds [B, S, V]: the
    sequence is padded to a multiple of ``cfg.loss_chunk`` (padding
    masked out) and each chunk's f32 logits are recomputed in the
    backward instead of kept. hidden [B, S, D]; labels [B, S] int; mask
    [B, S] f32 weights. Returns the weighted mean."""
    B, S, D = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(h, lab, m):
        logits = unembed(p, cfg, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return torch.sum((lse - gold) * m)

    remat = n > 1 and torch.is_grad_enabled()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], labels[:, sl], mask[:, sl])
        loss = checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False) if remat else body(*args)
        tot = tot + loss
        cnt = cnt + torch.sum(args[2])
    return tot / torch.clamp_min(cnt, 1.0)


def next_token_ce(p, cfg, h, tokens):
    """``chunked_ce`` of hidden ``h`` [B, S, D] against ``tokens`` [B, S]
    shifted by one, the last position of each row masked out."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    # zero_, not ``= 0.0``: item assignment of a number dispatches fill_
    # on the card and scalar_tensor + copy_ on the meta device, and the
    # two counts of a step (launch.op_cost) must agree
    mask[:, -1].zero_()
    return chunked_ce(p, cfg, h, labels, mask)


def lm_loss(p, cfg, batch, *, window="cfg"):
    """Next-token LM loss of one batch (a vlm's patch prefix carries no
    label); the last position of each row is masked out. A moe model adds
    0.01 times its load-balance loss, as ``repro`` does."""
    h, _, aux = forward(p, cfg, batch, window=window)
    tokens = batch["tokens"]
    n_prefix = h.shape[1] - tokens.shape[1]
    loss = next_token_ce(p, cfg, h[:, n_prefix:] if n_prefix else h, tokens)
    return loss + 0.01 * aux if cfg.family == "moe" else loss
