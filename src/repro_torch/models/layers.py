"""Shared building blocks: norms, RoPE, sinusoidal positions, SwiGLU, the
seeded inits and the robust-backward-aware product ``_dot``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import ctx as CTX


def dense_init(generator, shape, dtype, fan_in=None, device=None):
    """N(0, 1/fan_in) in f32, cast to ``dtype`` (fan_in defaults to
    shape[0], as in ``repro``)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / torch.sqrt(torch.tensor(float(max(fan_in, 1)),
                                          dtype=torch.float32, device=device))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(generator, shape, dtype, device=None):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rmsnorm(x, scale, eps=1e-5):
    """Normalise in f32, cast back to x's dtype, THEN multiply by the scale
    (the order ``repro`` uses)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rope_tables(positions, dh: int, theta: float = 10000.0):
    """(cos, sin) [..., S, 1, dh/2] f32 of the half-split rotary embedding
    at ``positions`` [..., S]: made once a forward or a decode step and
    read by every layer's q and k."""
    half = dh // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs  # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cos, sin):
    """Rotate x [..., S, H, dh] by the tables of :func:`rope_tables`."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Half-split rotary embedding. x: [..., S, H, dh]; positions: [..., S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoid(positions, d: int):
    """The f32 sinusoidal embedding [..., d] of int ``positions`` [...]:
    sin at the even features, cos at the odd ones, of position times
    exp(2i * -ln(10000) / d), in ``repro``'s f32 arithmetic. Made on the
    positions' device, so a decode step at per-row positions reads no
    host value."""
    dev = positions.device
    c = -torch.log(torch.full((), 10000.0, dtype=torch.float32,
                              device=dev)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=dev) * c)
    ang = positions.float()[..., None] * div  # [..., d/2]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        positions.shape + (d,))


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, device=None):
    """[n, d] sinusoidal positions 0..n-1, computed in f32 and then cast to
    ``dtype`` (``repro``'s ``sinusoidal_positions``; d even)."""
    return sinusoid(torch.arange(n, device=device), d).to(dtype)


def _dot(x, w):
    """``x @ w``; while a robust-backward context is active
    (``dist.robust_reduce.robust_backward``) a 3-D x 2-D product goes
    through ``robust_dot``, whose weight gradient is aggregated over the
    workers inside the backward (``repro``'s IB-RRS)."""
    if CTX.robust_backward_state() is not None and x.ndim == 3 \
            and w.ndim == 2:
        from ..dist.robust_reduce import robust_dot

        return robust_dot(x, w)
    return x @ w


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: (silu(x@wg) * (x@wu)) @ wd."""
    return _dot(F.silu(_dot(x, w_gate)) * _dot(x, w_up), w_down)
