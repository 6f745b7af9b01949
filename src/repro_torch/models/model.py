"""Model API, dense, vlm, moe, ssm, hybrid and encdec families
(``repro.models.model``'s counterpart).

    init(cfg, generator, device=None)               -> params
    loss(params, cfg, batch)                        -> scalar LM loss
    prefill(params, cfg, batch, ...)                -> (logits, caches)
    init_cache(cfg, batch, max_len, device=None)    -> caches
    decode_step(params, cfg, caches, token)         -> (logits [B, V], caches)

Caches carry ``pos`` as a per-row [B] int32 device tensor (a scalar
broadcasts); ``decode_step`` writes K/V (and an SSM's states) in place
and returns ``pos + 1`` as a new tensor. ``batch`` is ``{"tokens": [B,
S] int tensor}``, with ``"patches"`` [B, n_patches, D] for a vlm
(prepended; the logits and the cache cover the prefix) and ``"frames"``
[B, n_frames, D] for an encdec model (encoded; the logits and the self
cache cover the tokens only). ``init`` runs on the card unless
``device`` names another one (with no card it raises). The dense, vlm,
moe and ssm families share the decoder stack (``transformer``); the
hybrid has its own (``hybrid``), as has the encdec family (``whisper``).
"""
from __future__ import annotations

from ..device import resolve_device
from . import hybrid, transformer, whisper

_STACKS = {"hybrid": hybrid, "encdec": whisper}


def stack_module(cfg):
    """The module of ``cfg``'s stack: ``hybrid``, ``whisper`` or
    ``transformer``."""
    return _STACKS.get(cfg.family, transformer)


def init(cfg, generator, device=None):
    return stack_module(cfg).init(cfg, generator,
                                  device=resolve_device(device))


def loss(params, cfg, batch, window="cfg"):
    """Next-token LM loss (``transformer.lm_loss``; a moe model's includes
    0.01 times its load-balance loss), differentiable with autograd. A
    hybrid's or an encdec model's is ``chunked_ce`` of its hidden on the
    tied embedding, the last position masked, with no auxiliary term
    (``repro``'s aux is 0)."""
    if cfg.family in _STACKS:
        h, _, _ = stack_module(cfg).forward(params, cfg, batch,
                                            window=window)
        return transformer.next_token_ce({"embed": params["embed"]}, cfg, h,
                                         batch["tokens"])
    return transformer.lm_loss(params, cfg, batch, window=window)


def prefill(params, cfg, batch, window="cfg", cache_len=None,
            last_only: bool = False, out=None):
    """``last_only``: logits of the final position only, [B, 1, V] (the
    serving path never builds [B, S, V]). ``out``: stacked caches [L, B,
    ...] of the shape the prefill makes, to write the caches into (and
    return) instead of allocating them."""
    h, caches, _ = stack_module(cfg).forward(
        params, cfg, batch, window=window, make_cache=True,
        cache_len=cache_len, out=out)
    if last_only:
        h = h[:, -1:]
    if cfg.family in _STACKS:
        return stack_module(cfg).unembed(params, h), caches
    return transformer.unembed(params, cfg, h), caches


def init_cache(cfg, batch_size: int, max_len: int, window="cfg",
               device=None):
    return stack_module(cfg).init_cache(cfg, batch_size, max_len,
                                        window=window,
                                        device=resolve_device(device))


def decode_step(params, cfg, caches, token, window="cfg"):
    return stack_module(cfg).decode_step(params, cfg, caches, token,
                                         window=window)


def param_count(params) -> int:
    return sum(v.numel() if not isinstance(v, dict) else param_count(v)
               for v in params.values())


def active_param_count(params, cfg) -> int:
    """Parameters a token uses (for a FLOP count of 6 * N_active *
    tokens): all of them (an ssm, hybrid or encdec model's too), less
    the share (1 - top_k / n_experts) of a moe model's expert weights, as
    ``repro`` counts them."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    experts = params["layers"]["moe"]
    n = sum(experts[k].numel() for k in ("w_gate", "w_up", "w_down"))
    return int(total - n * (1 - cfg.moe.top_k / cfg.moe.n_experts))
