"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block:
``repro.models.mamba2``'s port.

The chunked SSD algorithm for training and prefill (the quadratic term
within a chunk, and a recurrence over the chunks' states), the exact
one-step recurrence for decode. Per head, the state h in R^{P x N}
(P = head_dim, N = d_state):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t
with A a negative scalar a head.

A bf16 model rounds where ``repro``'s does: the scan's weights ``W``, the
chunk states' weights ``sw``, the carried states and their decays are
cast to the input's dtype before they are contracted, the state ``h`` is
f32 and is cast to the input's dtype where C reads it. Where ``repro``
contracts three operands in one einsum, the port contracts them in pairs
in the order that einsum takes (the smaller product first: B or C with
its weights when N < P, x or the state otherwise), so the intermediates
round alike. ``repro``'s ``lax.scan`` over the chunk states is a loop over
the chunks; ``repro``'s ``jnp.repeat`` of the B/C groups over the heads is
an ``expand`` (no copy) when there is one group.

``SSMCache`` is stacked [L, B, ...] with the row on dim 1 and a per-row
``pos`` [B] int32, as ``attention.KVCache`` is. A decode step writes each
layer's state and conv tails into the caller's tensors in place, where
``repro`` returns new ones: a captured step sees only writes into the
addresses it captured. A prefill given ``out=`` writes its state there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .attention import row_pos
from .layers import dense_init, rmsnorm

__all__ = ["SSMCache", "mamba2_init", "init_cache", "ssd_chunked",
           "ssd_decode_step", "mamba2_forward", "mamba2_decode",
           "decode_layer"]


class SSMCache(NamedTuple):
    h: torch.Tensor        # [B, H, P, N] f32 ([L, B, H, P, N] stacked)
    conv: torch.Tensor     # [B, d_conv - 1, d_inner]    (the x stream)
    conv_bc: torch.Tensor  # [B, d_conv - 1, 2 * G * N]  (the B/C streams)
    pos: torch.Tensor      # [B] int32: tokens the rows have seen


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.head_dim, s.d_state, s.n_groups


def mamba2_init(generator, cfg, device=None, lead=()):
    """A block's params, every leaf with the leading dims ``lead`` (the
    stack's, e.g. (L,)): the split per-stream projections z / x / BC / dt
    and depthwise conv weights of ``repro`` (N(0, 1/fan_in)), ``A_log`` 0
    (A = -1), ``D`` 1 and ``dt_bias`` 0 in f32 whatever the param dtype,
    and a unit norm scale."""
    s = cfg.ssm
    d_inner, H, P, N, G = _dims(cfg)
    D = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    lead = tuple(lead)

    def dense(shape, fan_in):
        return dense_init(generator, lead + shape, dt, fan_in=fan_in,
                          device=device)

    def f32(fill):
        return torch.full(lead + (H,), fill, dtype=torch.float32,
                          device=device)

    return {
        "in_proj_z": dense((D, d_inner), D),
        "in_proj_x": dense((D, d_inner), D),
        "in_proj_bc": dense((D, 2 * G * N), D),
        "in_proj_dt": dense((D, H), D),
        "conv_x": dense((s.d_conv, d_inner), s.d_conv),
        "conv_bc": dense((s.d_conv, 2 * G * N), s.d_conv),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "norm": torch.ones(lead + (d_inner,), dtype=dt, device=device),
        "out_proj": dense((d_inner, D), d_inner),
    }


def init_cache(cfg, batch: int, n_layers: int, device=None) -> SSMCache:
    """Zeroed stacked caches [n_layers, batch, ...]: h in f32, the conv
    tails in the compute dtype, ``pos`` [batch] zeros."""
    s = cfg.ssm
    d_inner, H, P, N, G = _dims(cfg)
    dt = getattr(torch, cfg.compute_dtype)
    lead = (n_layers, batch)
    return SSMCache(
        h=torch.zeros(lead + (H, P, N), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (s.d_conv - 1, d_inner), dtype=dt,
                         device=device),
        conv_bc=torch.zeros(lead + (s.d_conv - 1, 2 * G * N), dtype=dt,
                            device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def _softplus(x):
    """``jax.nn.softplus``'s arithmetic: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _project(p, x):
    """x [B, S, D] -> (z, xs, BC, dt) through the per-stream projections."""
    return (x @ p["in_proj_z"], x @ p["in_proj_x"], x @ p["in_proj_bc"],
            x @ p["in_proj_dt"])


def _conv(xBC, w, state=None):
    """Causal depthwise conv over the sequence, then SiLU. xBC [B, S, Cd],
    w [K, Cd]; ``state``: the previous K - 1 inputs [B, K - 1, Cd] (zeros
    when None). Returns (y [B, S, Cd], the last K - 1 inputs)."""
    K = w.shape[0]
    S = xBC.shape[1]
    head = (xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
            if state is None else state.to(xBC.dtype))
    xpad = torch.cat([head, xBC], dim=1)
    y = sum(xpad[:, i:i + S] * w[i] for i in range(K))
    return F.silu(y), xpad[:, S:]


def _conv_step(state, x1, w):
    """One causal depthwise-conv step. state [B, K - 1, C], x1 [B, 1, C]
    -> (y [B, C], the new state [B, K - 1, C]: a view of a new tensor, so
    the caller may copy it over ``state``)."""
    conv_in = torch.cat([state.to(x1.dtype), x1], dim=1)
    y = sum(conv_in[:, i:i + 1] * w[i] for i in range(w.shape[0]))
    return F.silu(y)[:, 0], conv_in[:, 1:]


def _segsum(a):
    """a [..., L] log-decays -> [..., L, L]: out[t, s] = sum of a over
    (s, t] for s <= t, -inf above the diagonal (one mask, filled in
    place of a ``where``)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((L, L), dtype=torch.bool, device=a.device).triu(1)
    return diff.masked_fill_(upper, -float("inf"))


def _heads(B, H: int):
    """[..., G, N] -> [..., H, N]: head h reads group h // (H / G) (a view
    when G = 1)."""
    G, N = B.shape[-2:]
    if G == 1:
        return B.expand(B.shape[:-2] + (H, N))
    return B.repeat_interleave(H // G, dim=-2)


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan. x [b, S, H, P]; dt [b, S, H] (>= 0, f32); A [H]
    (< 0); B, C [b, S, G, N] (G divides H); ``h0``: the state before the
    first token [b, H, P, N] (zeros when None). S is padded to a multiple
    of ``chunk`` with dt = 0 (decay 1, no input), which leaves the last
    state exact. Returns (y [b, S, H, P] in x's dtype, h_T [b, H, P, N]
    f32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Bh, Ch = _heads(B, H), _heads(C, H)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk

    def r(t):  # [b, Sp, ...] -> [nc, b, chunk, ...]
        return t.reshape((b, nc, chunk) + t.shape[2:]).movedim(1, 0)

    xc, dtc, Bc, Cc = r(x), r(dt), r(Bh), r(Ch)
    dt_h = dtc.movedim(-1, -2)                  # [nc, b, H, L]
    a_h = dt_h.float() * A[:, None]             # log-decays, f32
    # the diagonal blocks: y[t] += sum_s C_t.B_s dt_s decay(t, s) x_s
    Lmat = torch.exp(_segsum(a_h))              # [nc, b, H, L, L]
    CB = torch.einsum("cbthn,cbshn->cbhts", Cc, Bc)
    W = CB * Lmat * dt_h[..., None, :]
    y_diag = torch.einsum("cbhts,cbshp->cbthp", W.to(x.dtype), xc)
    # each chunk's state: sum_s decay(end, s) dt_s B_s (x) x_s
    cum = torch.cumsum(a_h, dim=-1)
    sw = (torch.exp(cum[..., -1:] - cum) * dt_h).to(x.dtype)
    sw_s = sw.movedim(-1, -2)[..., None]        # [nc, b, L, H, 1]
    if N < P:
        states = torch.einsum("cbshn,cbshp->cbhpn", Bc * sw_s, xc)
    else:
        states = torch.einsum("cbshp,cbshn->cbhpn", xc * sw_s, Bc)
    chunk_decay = torch.exp(cum[..., -1])       # [nc, b, H]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[c][..., None, None] + states[c].float()
    hp = torch.stack(h_prevs).to(x.dtype)       # [nc, b, H, P, N]
    # the carried state: y[t] += C_t . (decay(t, start) h_prev)
    dfs = torch.exp(cum).to(x.dtype).movedim(-1, -2)[..., None]
    if N < P:
        y_off = torch.einsum("cbthn,cbhpn->cbthp", Cc * dfs, hp)
    else:
        y_off = torch.einsum("cbthn,cbhpn->cbthp", Cc, hp) * dfs
    y = (y_diag + y_off).movedim(0, 1).reshape(b, nc * chunk, H, P)
    return y[:, :S], h


def ssd_decode_step(x1, dt1, A, B1, C1, h, out=None):
    """One step of the recurrence. x1 [b, H, P], dt1 [b, H] (f32), B1/C1
    [b, G, N], h [b, H, P, N] f32. Returns (y [b, H, P], h_new); with
    ``out`` (``h`` itself for an update in place) h_new is written there,
    the same bits."""
    H = x1.shape[1]
    Bh, Ch = _heads(B1, H), _heads(C1, H)
    decay = torch.exp(dt1.float() * A)[..., None, None]
    upd = (dt1[..., None, None].float() * Bh[:, :, None, :].float()
           * x1[..., None].float())
    if out is None:
        h_new = h * decay + upd
    else:
        h_new = torch.mul(h, decay, out=out).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", h_new.to(x1.dtype), Ch)
    return y, h_new


def mamba2_forward(p, x, cfg, cache: SSMCache = None,
                   make_cache: bool = False, out: SSMCache = None):
    """The block over a sequence. x [B, S, D] -> (out [B, S, D], the
    layer's cache or None). ``cache``: a state to continue from (its
    ``pos`` advanced by S); ``out``: a layer's cache views to write the
    new state into (and return) with ``make_cache``."""
    s = cfg.ssm
    d_inner, H, P, N, G = _dims(cfg)
    z, xs, bc, dtp = _project(p, x)
    xs, conv = _conv(xs, p["conv_x"], None if cache is None else cache.conv)
    bc, conv_bc = _conv(bc, p["conv_bc"],
                        None if cache is None else cache.conv_bc)
    dt = _softplus(dtp.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    b, S = x.shape[:2]
    xh = xs.reshape(b, S, H, P)
    y, hT = ssd_chunked(xh, dt, A, bc[..., :G * N].reshape(b, S, G, N),
                        bc[..., G * N:].reshape(b, S, G, N), s.chunk,
                        h0=None if cache is None else cache.h)
    y = y + p["D"][:, None].to(y.dtype) * xh
    y = rmsnorm(y.reshape(b, S, d_inner) * F.silu(z), p["norm"],
                cfg.norm_eps)
    o = y @ p["out_proj"]
    if not make_cache:
        return o, None
    pos = (torch.full((b,), S, dtype=torch.int32, device=x.device)
           if cache is None else row_pos(cache.pos, b, x.device) + S)
    new = SSMCache(h=hT, conv=conv, conv_bc=conv_bc, pos=pos)
    if out is not None:
        for dst, src in zip(out, new):
            dst.copy_(src)
        new = out
    return o, new


def decode_layer(p, x1, cfg, h, conv, conv_bc):
    """One layer of a decode step: x1 [B, 1, D] -> out [B, 1, D]. Writes the
    new state into ``h`` [B, H, P, N] and the shifted conv tails into
    ``conv`` / ``conv_bc``, in place (each tail is read whole before it is
    written)."""
    d_inner, H, P, N, G = _dims(cfg)
    z, xs, bc, dtp = _project(p, x1)
    xs1, new_conv = _conv_step(conv, xs, p["conv_x"])
    bc1, new_conv_bc = _conv_step(conv_bc, bc, p["conv_bc"])
    conv.copy_(new_conv)
    conv_bc.copy_(new_conv_bc)
    dt1 = _softplus(dtp[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    b = x1.shape[0]
    xh = xs1.reshape(b, H, P)
    y, _ = ssd_decode_step(xh, dt1, A, bc1[:, :G * N].reshape(b, G, N),
                           bc1[:, G * N:].reshape(b, G, N), h, out=h)
    y = y + p["D"][:, None].to(y.dtype) * xh
    y = rmsnorm(y.reshape(b, 1, d_inner) * F.silu(z), p["norm"],
                cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_decode(p, x1, cfg, cache: SSMCache):
    """One-token decode of one layer's ``cache`` [B, ...]: writes it in
    place; returns (out [B, 1, D], the cache with ``pos + 1``)."""
    pos = row_pos(cache.pos, x1.shape[0], x1.device)
    out = decode_layer(p, x1, cfg, cache.h, cache.conv, cache.conv_bc)
    return out, cache._replace(pos=pos + 1)
