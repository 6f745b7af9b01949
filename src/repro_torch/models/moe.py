"""Top-k capacity-routed mixture of experts (``repro.models.moe``'s port).

Tokens are routed within groups: each batch row, cut into chunks of
``MOE_SEQ_CHUNK`` tokens when its length is a multiple of that (else the
whole row is one group). A group of T tokens gives every expert
``C = max(int(capacity_factor * top_k * T / n_experts), 1)`` rows; a
token's slot s takes the next free row of its expert after every token of
slots < s (``repro``'s sequential position carry), and a slot past C is
dropped. The expert FFNs are SwiGLU over weights stacked [E, ...].

Where ``repro`` dispatches and combines with one-hot einsums over
[T, E, C], the port gathers rows by index: a one-hot sum with a single
nonzero term is a copy, so the dispatched rows are the same values, and
the combine sums a token's kept slots in f32 and rounds once, as the
einsum does. The router product stays in the input's dtype and is cast to
f32 after it (bf16 logits tie often); the top-k puts the lower expert
index first on a tie, as ``jax.lax.top_k`` does. Every shape is static
and nothing is read on the host, so a decode step that routes can be
captured as a CUDA graph. The expert products are plain ``torch.bmm``:
``repro``'s einsums there are not robust in the backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["MOE_SEQ_CHUNK", "Routing", "capacity", "moe_init", "route",
           "moe_ffn"]

MOE_SEQ_CHUNK = 2048


class Routing(NamedTuple):
    """One routing decision over groups [G, T] of tokens."""

    expert: torch.Tensor  # [G, T, k] int64, slot-ordered (best first)
    pos: torch.Tensor     # [G, T, k] int64: row in the expert (may be >= C)
    keep: torch.Tensor    # [G, T, k] bool: pos < C
    gate: torch.Tensor    # [G, T, k] f32, normalised over the k slots
    probs: torch.Tensor   # [G, T, E] f32 router probabilities
    capacity: int         # C, the rows each expert takes a group


def capacity(cfg, T: int) -> int:
    """Rows an expert takes in a group of T tokens, computed as ``repro``
    computes it (a python float, truncated)."""
    m = cfg.moe
    return max(int(m.capacity_factor * m.top_k * T / m.n_experts), 1)


def moe_init(generator, cfg, device=None, n_layers=None):
    """Router [D, E] and experts ``w_gate``/``w_up`` [E, D, F], ``w_down``
    [E, F, D] at ``repro``'s fan-ins (D, D, D, F); with ``n_layers`` every
    leaf gets a leading [L]."""
    E, D, Fd = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    lead = () if n_layers is None else (n_layers,)
    dt = getattr(torch, cfg.param_dtype)

    def w(shape, fan_in):
        return dense_init(generator, lead + shape, dt, fan_in=fan_in,
                          device=device)

    return {"router": w((D, E), D), "w_gate": w((E, D, Fd), D),
            "w_up": w((E, D, Fd), D), "w_down": w((E, Fd, D), Fd)}


def _top_k(probs, k: int):
    """The k largest of ``probs`` [..., E], largest first and the lower
    index first among equal values (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): each expert's rank is the count of
    experts before it in that order. Returns (values, indices)."""
    E = probs.shape[-1]
    ar = torch.arange(E, device=probs.device)
    a, b = probs[..., :, None], probs[..., None, :]
    before = (b > a) | ((b == a) & (ar[None, :] < ar[:, None]))
    rank = before.sum(-1)  # [..., E]: a permutation of 0..E-1
    order = torch.empty_like(rank).scatter_(-1, rank, ar.expand_as(rank))
    idx = order[..., :k]
    return torch.gather(probs, -1, idx), idx


def route(x, router, cfg) -> Routing:
    """Route the groups ``x`` [G, T, D] over ``cfg.moe``'s experts."""
    m = cfg.moe
    G, T, _ = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, T)
    logits = torch.matmul(x, router).float()  # x's dtype, then f32
    probs = torch.softmax(logits, dim=-1)
    top, expert = _top_k(probs, k)
    gate = top / torch.sum(top, dim=-1, keepdim=True)
    # position in the expert, slot-major: every token of slot s after the
    # tokens of slots < s (one cumsum over the [k * T, E] one-hot)
    flat = expert.transpose(1, 2).reshape(G, k * T)
    onehot = flat[..., None] == torch.arange(E, device=x.device)
    pos = torch.cumsum(onehot, dim=1).gather(2, flat[..., None])[..., 0] - 1
    pos = pos.reshape(G, k, T).transpose(1, 2)
    return Routing(expert, pos, pos < C, gate, probs, C)


def _experts(p, x, cfg):
    """One routing and the expert FFNs over groups x [G, T, D] -> (y
    [G, T, D], aux [G])."""
    G, T, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    r = route(x, p["router"], cfg)
    C = r.capacity
    dev = x.device
    g = torch.arange(G, device=dev)[:, None, None]
    # dispatch: row (e, g, c) of the experts' input is the token that took
    # row c of expert e in group g, or the zero row G * T when none did
    tok = (g * T + torch.arange(T, device=dev)[:, None]).expand(G, T, k)
    dest = torch.where(r.keep, r.expert * (G * C) + g * C + r.pos,
                       E * G * C)
    src = torch.full((E * G * C + 1,), G * T, dtype=torch.long, device=dev)
    src.scatter_(0, dest.reshape(-1), tok.reshape(-1))
    x_rows = torch.cat([x.reshape(G * T, D), x.new_zeros((1, D))])
    xin = x_rows.index_select(0, src[:E * G * C]).view(E, G * C, D)
    h = torch.bmm(xin, p["w_gate"])
    u = torch.bmm(xin, p["w_up"])
    out = torch.bmm(F.silu(h) * u, p["w_down"])  # [E, G * C, D]
    # combine: a token's kept slots, gate (in x's dtype) times its expert
    # row, summed in f32 and rounded once; a dropped slot reads the zero
    # row and adds nothing
    out_rows = torch.cat([out.reshape(E * G * C, D), out.new_zeros((1, D))])
    picked = out_rows.index_select(0, dest.reshape(-1)).view(G, T, -1, D)
    w = r.gate.to(x.dtype).float()
    y = torch.sum(w[..., None] * picked.float(), dim=2).to(x.dtype)
    # Switch-style load-balance loss: E * sum_e frac_e * imp_e, frac over
    # the top-1 choices, imp the mean router probability
    first = r.expert[..., 0:1] == torch.arange(E, device=dev)
    frac = torch.mean(first.float(), dim=1)
    imp = torch.mean(r.probs, dim=1)
    return y, E * torch.sum(frac * imp, dim=-1)


def moe_ffn(p, x, cfg):
    """x [B, S, D] -> (y [B, S, D], aux: the load-balance loss, a 0-d f32
    mean over the groups). A row is cut into ``MOE_SEQ_CHUNK``-token groups
    when its length is a multiple of that, else it is one group."""
    B, S, D = x.shape
    c = min(MOE_SEQ_CHUNK, S)
    if S % c:
        c = S
    y, aux = _experts(p, x.reshape(B * (S // c), c, D), cfg)
    return y.reshape(B, S, D), torch.mean(aux)
