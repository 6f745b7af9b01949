"""Optimizers: SGD (+momentum), AdamW, Adafactor (``repro.optim``'s port).

Each optimizer is an ``Optimizer(init, update)`` pair — ``init(params) ->
state``, ``update(grads, state, params) -> (params, state)`` — selected by
name with :func:`get` (the ``ArchConfig.optimizer`` field). States are
dicts that mirror the params dict under ``repro``'s keys (``m``, ``v``,
``step``; adafactor's factored ``vr``/``vc``), so a state converts and
checkpoints across the two packages leaf for leaf. ``step`` is a 0-d int32
tensor on the params' device, so no update reads a value on the host.

The math is ``repro``'s, in f32 whatever the param dtype, the result cast
back to it. Unlike ``repro``, ``update`` writes the parameters and the
state in place under ``torch.no_grad()`` and returns the same objects:
one leaf at a time, with f32 temporaries of that leaf only (the moments
of a full-width model are most of the card's memory).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import at, leaves, paths, tree_map

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "get"]


class Optimizer(NamedTuple):
    init: Any    # params -> state
    update: Any  # (grads, state, params) -> (params, state), in place


def _step0(params):
    device = next(leaves(params)).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float = 1e-2, momentum: float = 0.0):
    def init(params):
        st = {"step": _step0(params)}
        if momentum != 0.0:
            st["m"] = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
        return st

    @torch.no_grad()
    def update(grads, state, params):
        for path, p in paths(params):
            g = at(grads, path)
            if momentum == 0.0:
                u = g.float().mul(-lr)
            else:
                m = at(state["m"], path)
                m.mul_(momentum).add_(g.float())
                u = m.mul(-lr)
            p.copy_(u.add_(p))  # p - lr * u, cast to p's dtype
        state["step"] += 1
        return params, state

    return Optimizer(init, update)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0):
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        t = state["step"].float()
        c1 = 1.0 - torch.pow(b1, t)  # f32 on the device, as repro's
        c2 = 1.0 - torch.pow(b2, t)
        for path, p in paths(params):
            g = at(grads, path).float()
            m = at(state["m"], path)
            v = at(state["v"], path)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_((1 - b2) * g * g)
            del g
            den = torch.div(v, c2).sqrt_().add_(eps)
            u = torch.div(m, c1).div_(den)
            del den
            if weight_decay:
                u.add_(p.float() * weight_decay)
            p.copy_(u.mul_(-lr).add_(p))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: float = 1e-3, eps: float = 1e-30, momentum: float = 0.9,
              momentum_dtype=torch.bfloat16, clip_rms: float = 1.0,
              decay: float = 0.8):
    """Factored second moment (Shazeer & Stern 2018), bf16 first moment."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def vstate(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        st = {"v": tree_map(vstate, params), "step": _step0(params)}
        if momentum:
            st["m"] = tree_map(lambda p: torch.zeros_like(
                p, dtype=momentum_dtype), params)
        return st

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        t = state["step"].float()
        beta2 = 1.0 - torch.pow(t, -decay)
        for path, p in paths(params):
            g = at(grads, path).float()
            vs = at(state["v"], path)
            g2 = g * g + eps
            if _factored(p):
                vs["vr"].mul_(beta2).add_((1 - beta2)
                                          * torch.mean(g2, dim=-1))
                vs["vc"].mul_(beta2).add_((1 - beta2)
                                          * torch.mean(g2, dim=-2))
                del g2
                vr, vc = vs["vr"], vs["vc"]
                denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                        eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
            else:
                vs["v"].mul_(beta2).add_((1 - beta2) * g2)
                del g2
                vhat = vs["v"]
            u = g / torch.sqrt(vhat + eps)
            del vhat, g
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u.div_(torch.clamp_min(rms / clip_rms, 1.0))
            if momentum:
                m = at(state["m"], path)
                u = (momentum * m.float()).add_((1 - momentum) * u)
                m.copy_(u)
            p.copy_(u.mul_(-lr).add_(p))
        return params, state

    return Optimizer(init, update)


def get(name: str, **kwargs) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}[name](**kwargs)
