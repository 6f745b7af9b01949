"""Prefill-then-decode serving engine (``repro.serve.engine``'s port).

``generate`` prefills a [B, S] prompt batch (after a vlm's stub patch
embeddings), samples the first token off the prefill logits, then decodes
in a plain Python loop (``repro`` scans with ``lax.scan``; CUDA graphs of
the step are later work). With a
``RobustDecodeConfig`` every token — the first one included — comes from
the robust aggregate of an m-replica logit stack (``serve.robust``).

The engine runs on the card unless the caller passes ``device="cpu"``;
with no card and no device it raises. On the card the default backends
run the CUDA kernels: flash attention for prefill, decode attention for
every step, and the fused aggregate + sample tail for each robust greedy
or top-k token (the aggregation kernel for temperature sampling or with
``fuse_tail=False``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from . import robust as R

__all__ = ["Sampling", "GREEDY", "sample_tokens", "categorical",
           "ServeEngine"]


class Sampling(NamedTuple):
    """Sampling config. method: 'greedy' | 'temperature' | 'top_k'."""

    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0


GREEDY = Sampling()


def categorical(logits, generator):
    """One draw per row of softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample_tokens(logits, generator, sc: Sampling):
    """logits [..., V] -> sampled token ids [...] int32."""
    if sc.method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.float() / max(sc.temperature, 1e-6)
    if sc.method == "top_k":
        if sc.top_k <= 0:
            raise ValueError("top_k sampling needs top_k > 0")
        kth = torch.topk(l, sc.top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, torch.full_like(l, -float("inf")), l)
    elif sc.method != "temperature":
        raise ValueError(sc.method)
    return categorical(l, generator)


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServeEngine:
    """Holds (cfg, params) on one device and serves fixed-batch requests.

    max_len:      KV capacity per sequence (prompt + generated must fit).
    robust:       optional ``RobustDecodeConfig``: decode replicated over
                  ``robust.m`` replicas with robust logit aggregation.
    attn_backend: optional override of ``cfg.attn_backend``.
    kv_dtype:     optional override of ``cfg.kv_dtype``.
    device:       None = the card (raises without one); "cpu" runs the
                  kernels' plain versions on the host.
    """

    def __init__(self, cfg, params, *, max_len: int, window="cfg",
                 robust: Optional[R.RobustDecodeConfig] = None,
                 attn_backend: Optional[str] = None,
                 kv_dtype: Optional[str] = None, device=None):
        from ..models.attention import KV_DTYPES
        from ..models.attn_backend import BACKENDS

        self.device = resolve_device(device)
        if attn_backend is not None:
            if attn_backend not in BACKENDS:
                raise ValueError(f"unknown attn backend {attn_backend!r}; "
                                 f"known: {BACKENDS}")
            cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
        if kv_dtype is not None:
            if kv_dtype not in KV_DTYPES:
                raise ValueError(f"unknown kv dtype {kv_dtype!r}; "
                                 f"known: {KV_DTYPES}")
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_len = int(max_len)
        self.window = window
        self.robust = robust
        self._replicated = (robust is not None
                            and not robust.share_replica_compute)

    def _inputs(self, batch):
        """(the batch on the engine's device, its prompt length). The prompt
        length counts a vlm's patch prefix, which takes cache positions as
        tokens do (``repro`` counts the tokens only, ROADMAP.md §C)."""
        def dev(x):
            return (x if torch.is_tensor(x)
                    else torch.from_numpy(np.asarray(x))).to(self.device)

        inputs = {"tokens": dev(batch["tokens"]).long()}
        n = inputs["tokens"].shape[1]
        if "patches" in batch:
            inputs["patches"] = dev(batch["patches"])
            if self.cfg.family == "vlm":
                n += inputs["patches"].shape[1]
        return inputs, n

    def _check_capacity(self, prompt_len: int, n_tokens: int) -> None:
        # prompt + one K/V write per decode step (the first token samples
        # off the prefill logits); past max_len the prefill cache would
        # drop the prompt's last positions and the linear cache clamp to
        # its last slot, corrupting attention
        need = prompt_len + n_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"prompt {prompt_len} + {n_tokens} tokens needs {need} "
                f"cache slots > max_len {self.max_len}")

    def _prefill(self, inputs):
        logits, caches = M.prefill(self.params, self.cfg, inputs,
                                   window=self.window, cache_len=self.max_len,
                                   last_only=True)
        return logits[:, -1], caches

    @torch.inference_mode()
    def prefill(self, batch):
        """-> (last-position logits [B, V], stacked caches). ``batch``:
        ``tokens`` [B, S], and ``patches`` [B, n_patches, D] for a vlm."""
        inputs, prompt_len = self._inputs(batch)
        self._check_capacity(prompt_len, 1)
        return self._prefill(inputs)

    def _first_token(self, logits, generator, sc):
        """Token 0 from the prefill logits. With a robust config they go
        through the same attack + aggregation as decode (the prefill
        forward is deterministic, so stacking its logits equals running it
        on every replica)."""
        rcfg = self.robust
        if rcfg is None:
            return sample_tokens(logits, generator, sc)
        rep = logits[None].expand((rcfg.m,) + logits.shape)
        return R.robust_sample(rep, rcfg, generator, sc)

    def _decode_step(self, tok, caches, generator, sc):
        """One step of decode -> (attack, aggregate) -> sample."""
        rcfg = self.robust
        if rcfg is None:
            logits, caches = M.decode_step(self.params, self.cfg, caches, tok,
                                           window=self.window)
            return sample_tokens(logits, generator, sc), caches
        if rcfg.share_replica_compute:
            # one forward feeds the whole wire stack
            logits, caches = M.decode_step(self.params, self.cfg, caches, tok,
                                           window=self.window)
            logits_r = logits[None].expand((rcfg.m,) + logits.shape)
        else:
            # all m replicas as one step at batch m * B, replica-major
            logits_f, caches = M.decode_step(self.params, self.cfg, caches,
                                             tok.repeat(rcfg.m),
                                             window=self.window)
            logits_r = logits_f.reshape((rcfg.m, tok.shape[0])
                                        + logits_f.shape[1:])
        return R.robust_sample(logits_r, rcfg, generator, sc), caches

    @torch.inference_mode()
    def generate(self, batch, n_tokens: int, sampling: Sampling = GREEDY,
                 generator: Optional[torch.Generator] = None):
        """Prefill + decode loop -> tokens [B, n_tokens] int32.

        ``generator`` (on the engine's device) drives sampling and attack
        noise; None seeds a fresh one with 0."""
        inputs, prompt_len = self._inputs(batch)
        self._check_capacity(prompt_len, n_tokens)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits, caches = self._prefill(inputs)
        tok = self._first_token(logits, generator, sampling)
        out = [tok]
        if self._replicated and n_tokens > 1:
            caches = R.flatten_replicas(
                R.stack_replicas(caches, self.robust.m), self.robust.m)
        for _ in range(n_tokens - 1):
            tok, caches = self._decode_step(tok, caches, generator, sampling)
            out.append(tok)
        return torch.stack(out, dim=1)
