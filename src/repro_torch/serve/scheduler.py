"""Continuous-batching scheduler (``repro.serve.scheduler``'s port).

Host-side orchestration over the engine: a FIFO request queue, admission
of variable-length prompts into free pool slots *mid-decode*, and
retirement of completed sequences (EOS or token budget) that frees their
slots for the next queued request. The device work is a batch-1 prefill
per admission and a ``decode_pool`` block of ``decode_block`` tokens (on
the card, that many replays of the pool's captured step), so the host
reads the device once a block, not once a token.

Completion is detected at block granularity: a sequence that hits EOS
mid-block has its overshoot tokens trimmed on the host (the overshoot
writes land in a slot that is about to be recycled, and admission
overwrites every cache row of the slot, its positions included — stale
state never leaks into the next request).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.metrics import now as _now
from .engine import GREEDY, Sampling, ServeEngine

__all__ = ["Request", "Completion", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request. ``extras`` carries modality inputs (a vlm's
    patches, an encdec model's frames) keyed as the model batch expects. ``submit_t`` is stamped by
    ``Scheduler.submit`` (obs clock) so admission can observe
    time-to-first-token including queue wait."""

    tokens: np.ndarray  # [S] int32 prompt
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    uid: Optional[int] = None
    extras: Optional[dict] = None
    submit_t: Optional[float] = None


@dataclasses.dataclass
class Completion:
    uid: int
    prompt: np.ndarray
    tokens: List[int]          # generated ids (includes EOS when hit)
    finished_by: str           # 'eos' | 'length' | 'rejected'


class Scheduler:
    """Drives admit -> decode -> retire over a ``ServeEngine`` pool.

    Telemetry (when the engine carries an ``obs.MetricsRegistry``): queue
    depth and slot occupancy gauges, admitted/rejected/retired/tokens
    counters, TTFT (submit -> first token, queue wait included) and
    per-token decode-step latency histograms, as ``repro`` records them.
    All host-side; with ``obs=None`` no telemetry code runs.

    Set-up exclusion: the first admission at a prompt shape and the first
    decode block set up their work (on the card: lazy kernel and cuBLAS
    loading; the block's eager first step and the capture of its step),
    so those dispatches are far above steady state. They go to the
    ``serve.compile_s`` gauge (last-wins, like every gauge) instead of the
    TTFT / decode-step histograms.

    Randomness: one ``torch.Generator`` on the engine's device, seeded
    with ``seed``, feeds every admission and block in turn (``repro``
    splits a key for each).
    """

    def __init__(self, engine: ServeEngine, *, decode_block: int = 4,
                 sampling: Sampling = GREEDY, seed: int = 0):
        if decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        self.engine = engine
        self._obs = engine.obs
        self.decode_block = int(decode_block)
        self.sampling = sampling
        self.pool = engine.make_pool()
        n = engine.n_slots
        self.queue: collections.deque = collections.deque()
        self.completed: Dict[int, Completion] = {}
        self._uid = itertools.count()
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._slot_req: List[Optional[Request]] = [None] * n
        self._slot_out: List[List[int]] = [[] for _ in range(n)]
        self._cur_tok = np.zeros((n,), np.int32)
        # prompt shapes already admitted once, and whether a decode block
        # has run: first dispatches are set-up time, not latency samples
        self._warm_prefill: set = set()
        self._decode_warm = False

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> int:
        if req.uid is None:
            req.uid = next(self._uid)
        req.tokens = np.asarray(req.tokens, np.int32)
        if req.tokens.ndim != 1 or req.tokens.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req.submit_t = _now()
        self.queue.append(req)
        return req.uid

    # -- internals ----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is None]

    def _finish(self, slot: int, by: str) -> None:
        req = self._slot_req[slot]
        self.completed[req.uid] = Completion(
            uid=req.uid, prompt=req.tokens,
            tokens=self._slot_out[slot], finished_by=by)
        if self._obs is not None:
            self._obs.counter("serve.retired")
            self._obs.counter("serve.tokens_out", len(self._slot_out[slot]))
        self._slot_req[slot] = None
        self._slot_out[slot] = []
        self.pool = self.engine.evict(self.pool, slot)

    def _ingest(self, slot: int, new_tokens: List[int]) -> None:
        """Append a slot's new tokens, trimming at EOS / budget, and
        retire it when done."""
        req = self._slot_req[slot]
        out = self._slot_out[slot]
        for t in new_tokens:
            out.append(int(t))
            if req.eos_id is not None and int(t) == req.eos_id:
                self._finish(slot, "eos")
                return
            if len(out) >= req.max_new_tokens:
                self._finish(slot, "length")
                return

    def _admit(self) -> None:
        """Fill free slots from the queue (FIFO). A request that cannot
        fit its prompt plus token budget (with block overshoot) into a
        slot is rejected onto ``completed`` (finished_by='rejected')
        rather than wedging the queue head or corrupting a cache row."""
        for slot in self._free_slots():
            while self.queue:
                req = self.queue.popleft()
                # worst-case cache writes: prompt + budget + block
                # overshoot (retirement is block-granular)
                need = (req.tokens.shape[0] + req.max_new_tokens
                        + self.decode_block - 1)
                if need <= self.engine.max_len:
                    break
                self.completed[req.uid] = Completion(
                    uid=req.uid, prompt=req.tokens, tokens=[],
                    finished_by="rejected")
                if self._obs is not None:
                    self._obs.counter("serve.rejected")
            else:
                break
            batch = {"tokens": req.tokens[None]}
            if req.extras:
                # extras are per-request (unbatched) arrays, e.g. frames
                # [F, D] or patches [P, D]; prepend the batch-1 dim
                for k, v in req.extras.items():
                    batch[k] = np.asarray(v)[None]
            shape_key = (req.tokens.shape[0],
                         tuple(sorted(req.extras)) if req.extras else ())
            t_admit = _now()
            self.pool, first = self.engine.admit(
                self.pool, slot, batch, sampling=self.sampling,
                generator=self._gen)
            if self._obs is not None:
                self._obs.counter("serve.admitted")
                if shape_key not in self._warm_prefill:
                    # first prefill at this shape: set-up time, not a
                    # TTFT sample
                    self._obs.gauge("serve.compile_s", _now() - t_admit)
                elif req.submit_t is not None:
                    # admit() returned the first token as a host int, so
                    # the device work is done: submit -> here is TTFT
                    # with queue wait included
                    self._obs.observe("serve.ttft_s", _now() - req.submit_t)
            self._warm_prefill.add(shape_key)
            self._slot_req[slot] = req
            self._slot_out[slot] = []
            self._cur_tok[slot] = first
            self._ingest(slot, [first])

    def _active_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    # -- main loop ----------------------------------------------------------

    def step(self) -> bool:
        """One admit + decode-block cycle. Returns False when idle."""
        self._admit()
        active = self._active_slots()
        if not active:
            return False
        if self._obs is not None:
            self._obs.gauge("serve.queue_depth", len(self.queue))
            self._obs.gauge("serve.slots_active", len(active))
        t0 = _now()
        self.pool, toks = self.engine.decode_pool(
            self.pool, self._cur_tok, self.decode_block,
            sampling=self.sampling, generator=self._gen)
        # [decode_block, n_slots] on the host: the block's device work is
        # done, so the block time is real
        toks = toks.cpu().numpy()
        if self._obs is not None:
            if self._decode_warm:
                self._obs.observe("serve.decode_step_s",
                                  (_now() - t0) / self.decode_block)
            else:
                # first block: its eager first step and the capture
                self._obs.gauge("serve.compile_s", _now() - t0)
        self._decode_warm = True
        self._cur_tok = toks[-1].astype(np.int32).copy()
        for slot in active:
            self._ingest(slot, list(toks[:, slot]))
        return True

    def run(self) -> Dict[int, Completion]:
        """Drain the queue. Returns completions keyed by request uid."""
        while self.queue or self._active_slots():
            self.step()
        return self.completed
