"""Prefill-then-decode serving engine (``repro.serve.engine``'s port).

Two entry styles over one decode step:

* fixed-batch ``generate`` prefills a [B, S] prompt batch (after a vlm's
  stub patch embeddings; with an encdec model's stub frames, encoded into
  its cross caches) into cache buffers the engine keeps for that
  batch size, samples the first token off the prefill logits, then
  decodes. ``repro`` decodes all tokens in one ``lax.scan`` dispatch; on
  the card the port's counterpart captures ONE decode step (embed,
  layers, unembed, attack, aggregate, sample, the advance of the
  positions) into a CUDA graph over those buffers, once per sampling
  config, and replays it every token: a token is one graph launch from
  the host instead of thousands of kernel launches. On the CPU the same
  step runs eagerly. ``generate_python_loop`` keeps the eager per-token
  loop under ``repro``'s name: the baseline.
* slot-pool ``admit`` / ``decode_pool`` / ``evict``, the
  continuous-batching path (``serve.scheduler`` drives it): a request's
  prompt prefills at batch 1 into a free slot of a ``cache.SlotPool``
  while the other slots keep decoding, and ``decode_pool`` advances every
  slot a block of tokens, the pool's step captured and replayed as
  ``generate``'s is.

With a ``RobustDecodeConfig`` every token — the first one included —
comes from the robust aggregate of an m-replica logit stack
(``serve.robust``). With ``obs`` (a ``MetricsRegistry``) and a robust
config, each decode step also adds the per-token replica-disagreement
rates into fixed-edge counts on the device, drained into the
``serve.replica_disagreement`` histogram with one host read a dispatch.

The engine runs on the card unless the caller passes ``device="cpu"``;
with no card and no device it raises. On the card the default backends
run the CUDA kernels: flash attention for prefill, decode attention for
every step, and the fused aggregate + sample tail for each robust greedy
or top-k token (the aggregation kernel for temperature sampling or with
``fuse_tail=False``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from ..models.caches import row_fields
from ..obs.catalog import FRACTION_EDGES
from ..obs.metrics import now
from . import cache as C
from . import robust as R

__all__ = ["Sampling", "GREEDY", "sample_tokens", "categorical",
           "ServeEngine", "DecodeBuffers", "StepGraph", "MAX_GRAPHS"]


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


# captured steps an engine keeps, one per sampling config (the least
# recently used goes first), for generate and for the pool each; they
# share one memory pool
MAX_GRAPHS = 4


class DecodeBuffers:
    """The static buffers a decode step reads and writes, for B rows.

    ``caches``: stacked caches [L, m * B, ...] of the model's type (m = 1
    unless the replicas run replicated, replica-major as
    ``robust.flatten_replicas`` lays them out) with ``pos`` [m * B]: new
    ones, or a slot pool's (``caches=``).
    For ``generate`` the prefill writes replica 0's rows and
    :meth:`replicate` copies them to the others. ``tok`` [B]: the token
    the next step reads; ``out`` [max_len, B] int32: the step's tokens by
    row ``t`` [1]. ``active``: a pool's [B] bool slot mask, else None.
    With ``diag``: ``edges`` (``FRACTION_EDGES`` on the device) and
    ``diag`` [len(edges) + 2] f64, the replica-disagreement histogram the
    steps add into: the bucket counts, then the sum of the rates, so one
    read drains both.
    """

    def __init__(self, cfg, batch: int, m: int, max_len: int, window,
                 device, caches=None,
                 diag: bool = False):
        # the slots the prefill makes: a ring of `window`, else max_len
        self.caches = caches if caches is not None else C.pool_caches(
            cfg, batch, max_len, window=window, m=m, device=device)
        self.m, self.batch = m, batch
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.out = torch.zeros((max_len, batch), dtype=torch.int32,
                               device=device)
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)
        self.active = None
        self.edges = self.diag = None
        if diag:
            self.edges = torch.tensor(FRACTION_EDGES, dtype=torch.float32,
                                      device=device)
            self.diag = torch.zeros((len(FRACTION_EDGES) + 2,),
                                    dtype=torch.float64, device=device)

    def rows(self):
        """Replica 0's caches [L, B, ...]: views the prefill writes."""
        B = self.batch
        return self.caches._replace(
            pos=self.caches.pos[:B],
            **{f: getattr(self.caches, f)[:, :B]
               for f in row_fields(self.caches)})

    def replicate(self) -> None:
        """Copy replica 0's caches (every row tensor) into the other m - 1."""
        if self.m == 1:
            return
        for f in row_fields(self.caches):
            x = getattr(self.caches, f)
            r = x.view((x.shape[0], self.m, -1) + x.shape[2:])
            r[:, 1:].copy_(r[:, :1])
        r = self.caches.pos.view(self.m, -1)
        r[1:].copy_(r[:1])

    def start(self, tok) -> None:
        """Token 0 in; the next step writes row 1."""
        self.tok.copy_(tok)
        self.out[0].copy_(tok)
        self.t.fill_(1)

    def reset_diag(self) -> None:
        if self.diag is not None:
            self.diag.zero_()


class StepGraph:
    """One decode step captured as a CUDA graph over a ``DecodeBuffers``.
    ``generator``: the graph's own generator, registered with the graph;
    the caller's state is copied in before the replays and back after
    them. ``capture_s``: host seconds of the capture; ``replays``: replays
    so far."""

    def __init__(self, device):
        self.graph = torch.cuda.CUDAGraph()
        self.generator = torch.Generator(device=device)
        self.graph.register_generator_state(self.generator)
        self.capture_s = None
        self.replays = 0


class ServeEngine:
    """Holds (cfg, params, pool geometry) on one device; serves
    fixed-batch requests (``generate``) and a slot pool (``admit``,
    ``decode_pool``, ``evict``).

    max_len:      KV capacity per sequence / slot (prompt + generated must
                  fit).
    n_slots:      pool capacity — concurrent sequences, decoupled from the
                  number of queued requests.
    robust:       optional ``RobustDecodeConfig``: decode replicated over
                  ``robust.m`` replicas with robust logit aggregation.
    attn_backend: optional override of ``cfg.attn_backend``.
    kv_dtype:     optional override of ``cfg.kv_dtype``.
    obs:          optional ``obs.MetricsRegistry``: the
                  ``serve.kv_bytes_per_slot`` gauge at construction and,
                  with a robust config, the ``serve.replica_disagreement``
                  histogram of every decode dispatch (``generate`` and
                  ``decode_pool``). Tokens are bit-identical to
                  ``obs=None``: the diagnostic reads the attacked logit
                  stack and the aggregate and feeds nothing back.
    device:       None = the card (raises without one); "cpu" runs the
                  kernels' plain versions on the host.
    """

    def __init__(self, cfg, params, *, max_len: int, n_slots: int = 4,
                 window="cfg", robust: Optional[R.RobustDecodeConfig] = None,
                 attn_backend: Optional[str] = None,
                 kv_dtype: Optional[str] = None, obs=None, device=None):
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
        self.n_slots = int(n_slots)
        self.window = window
        self.robust = robust
        self.obs = obs
        self._replicated = (robust is not None
                            and not robust.share_replica_compute)
        # replica rows a sequence holds in the caches
        self._m = robust.m if self._replicated else 1
        self._diag = obs is not None and robust is not None
        # the decode step's buffers, for one batch size at a time, and the
        # step captured over them by sampling config (the engine fixes
        # max_len, robust config and layout, window and kv dtype): at most
        # MAX_GRAPHS, the least recently used dropped first; the same for
        # one slot pool at a time; all in one memory pool (no two graphs
        # run at once, and each copies its outputs out of the memory pool
        # before the next one runs)
        self.buffers: Optional[DecodeBuffers] = None
        self.graphs: "OrderedDict[Sampling, StepGraph]" = OrderedDict()
        self.pool_buffers: Optional[DecodeBuffers] = None
        self.pool_graphs: "OrderedDict[Sampling, StepGraph]" = OrderedDict()
        self.capture_stream = None
        self._pool = None
        if obs is not None:
            # capacity gauge: the KV bytes one slot costs (int8 scales and
            # the m replica rows of the replicated layout included), from
            # caches built on the meta device: nothing is allocated
            obs.gauge("serve.kv_bytes_per_slot", float(C.kv_bytes_per_slot(
                lambda n: C.pool_caches(self.cfg, n, self.max_len,
                                        window=self.window, m=self._m,
                                        device="meta"), self.n_slots)))

    def _inputs(self, batch):
        """(the batch on the engine's device, its prompt length). The prompt
        length counts a vlm's patch prefix, which takes cache positions as
        tokens do (``repro`` counts the tokens only, ROADMAP.md §C); an
        encdec model's ``frames`` go to its encoder and take none."""
        def dev(x):
            return (x if torch.is_tensor(x)
                    else torch.from_numpy(np.asarray(x))).to(self.device)

        inputs = {"tokens": dev(batch["tokens"]).long()}
        n = inputs["tokens"].shape[1]
        if "patches" in batch:
            inputs["patches"] = dev(batch["patches"])
            if self.cfg.family == "vlm":
                n += inputs["patches"].shape[1]
        if "frames" in batch:
            inputs["frames"] = dev(batch["frames"])
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

    def _prefill(self, inputs, out=None):
        logits, caches = M.prefill(self.params, self.cfg, inputs,
                                   window=self.window, cache_len=self.max_len,
                                   last_only=True, out=out)
        return logits[:, -1], caches

    @torch.inference_mode()
    def prefill(self, batch):
        """-> (last-position logits [B, V], stacked caches). ``batch``:
        ``tokens`` [B, S], and ``patches`` [B, n_patches, D] for a vlm or
        ``frames`` [B, n_frames, D] for an encdec model."""
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

    def _decode_step(self, tok, caches, generator, sc: Sampling,
                     with_diag: bool = False):
        """One step of decode -> (attack, aggregate) -> sample: (tok,
        caches, the replica-disagreement rates [B] with ``with_diag``, else
        None)."""
        rcfg = self.robust
        if rcfg is None:
            logits, caches = M.decode_step(self.params, self.cfg, caches, tok,
                                           window=self.window)
            return sample_tokens(logits, generator, sc), caches, None
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
        if with_diag:
            tok, dis = R.robust_sample(logits_r, rcfg, generator, sc,
                                       with_diag=True)
            return tok, caches, dis
        return R.robust_sample(logits_r, rcfg, generator, sc), caches, None

    def _step(self, buf: DecodeBuffers, generator, sc: Sampling) -> None:
        """One decode step over ``buf``: reads ``buf.tok`` and the caches,
        writes the next token into ``buf.tok`` and row ``buf.t`` of
        ``buf.out``, advances the positions and ``buf.t``, and with diag
        buffers adds the step's disagreement counts (a pool's free slots
        masked out). Nothing reads a device value on the host, so a CUDA
        graph captures it whole."""
        from ..obs.diag import serve_diag

        tok, caches, dis = self._decode_step(
            buf.tok, buf.caches, generator, sc,
            with_diag=buf.diag is not None)
        buf.caches.pos.copy_(caches.pos)
        buf.out.index_copy_(0, buf.t, tok[None])
        buf.t.add_(1)
        buf.tok.copy_(tok)
        if dis is not None:
            # reprolint-torch: disable=RL003 buf.edges is on the device
            counts, total = serve_diag(dis, buf.edges, mask=buf.active)
            buf.diag[:-1].add_(counts)
            buf.diag[-1].add_(total)

    def _drain_diag(self, buf: DecodeBuffers) -> None:
        """Fold the dispatch's disagreement counts into the registry: one
        device-to-host read of the counts and their sum. The number of
        rates is the sum of the counts (every live rate lands in one
        bucket): (n_tokens - 1) * B for ``generate``, n_steps * the active
        slots for ``decode_pool``."""
        vals = buf.diag.tolist()
        counts = [int(c) for c in vals[:-1]]
        self.obs.histogram("serve.replica_disagreement").merge_counts(
            counts, vals[-1], sum(counts))

    def _buffers(self, batch: int) -> DecodeBuffers:
        """The buffers for ``batch`` rows; another batch size replaces them
        and drops the steps captured over them."""
        if self.buffers is None or self.buffers.batch != batch:
            self.graphs.clear()
            self.buffers = None  # freed before the new ones are made
            window = (self.cfg.sliding_window if self.window == "cfg"
                      else self.window)
            self.buffers = DecodeBuffers(self.cfg, batch, self._m,
                                         self.max_len, window, self.device,
                                         diag=self._diag)
        return self.buffers

    def _capture(self, buf: DecodeBuffers, sc, graphs) -> StepGraph:
        """Capture one step on the capture stream, where the step has just
        run eagerly: B3's and B4's scratch and tickets for that stream,
        cuBLAS's workspace, each kernel's one-time attribute set-up and
        every table the step caches exist before the capture begins
        (PyTorch's side-stream warm-up). A capture that fails raises."""
        t0 = now()
        st = StepGraph(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            with torch.cuda.graph(st.graph, pool=self._pool,
                                  stream=self.capture_stream):
                self._step(buf, st.generator, sc)
        except Exception as exc:
            self._pool = None  # a failed capture leaves its pool unusable
            raise RuntimeError(
                "capturing the decode step as a CUDA graph failed; a step "
                "must make no host-to-device copy and read no device "
                "value on the host") from exc
        st.capture_s = now() - t0
        graphs[sc] = st
        while len(graphs) > MAX_GRAPHS:
            graphs.popitem(last=False)
        return st

    def _decode(self, buf: DecodeBuffers, steps: int, generator, sc,
                graphs) -> None:
        """``steps`` decode steps over ``buf``. On the card: the first step
        of a new sampling config runs eagerly on the capture stream and is
        then captured into ``graphs``; every other step is a replay, which
        advances the caller's generator exactly as the eager step does."""
        if self.device.type != "cuda":
            for _ in range(steps):
                self._step(buf, generator, sc)
            return
        st = graphs.get(sc)
        if st is None:
            if self.capture_stream is None:
                self.capture_stream = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            self.capture_stream.wait_stream(current)
            with torch.cuda.stream(self.capture_stream):
                self._step(buf, generator, sc)
            current.wait_stream(self.capture_stream)
            steps -= 1
            if steps == 0:
                return
            st = self._capture(buf, sc, graphs)
        else:
            graphs.move_to_end(sc)
        st.generator.set_state(generator.get_state())
        for _ in range(steps):
            st.graph.replay()
        generator.set_state(st.generator.get_state())
        st.replays += steps

    def _generator(self, generator, seed: int = 0):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return generator

    def _start(self, batch, n_tokens: int, sampling, generator):
        """Prefill into new caches and token 0: -> (caches, tok [B],
        generator)."""
        inputs, prompt_len = self._inputs(batch)
        self._check_capacity(prompt_len, n_tokens)
        generator = self._generator(generator)
        logits, caches = self._prefill(inputs)
        return caches, self._first_token(logits, generator, sampling), \
            generator

    @torch.inference_mode()
    def generate(self, batch, n_tokens: int, sampling: Sampling = GREEDY,
                 generator: Optional[torch.Generator] = None):
        """Prefill + decode -> tokens [B, n_tokens] int32.

        The prefill writes its caches straight into the engine's
        ``DecodeBuffers`` for this batch size. On the card the decode step
        is captured once per sampling config (``self.graphs``) and
        replayed for every token, each replay writing its token into a
        [max_len, B] buffer; one host sync at the end. There is no eager
        fallback: a capture or replay that fails raises. On the CPU the
        same step runs eagerly. ``generator`` (on the engine's device)
        drives sampling and attack noise; None seeds a fresh one with 0.
        The same seed gives the same tokens as ``generate_python_loop``."""
        from ..obs.trace import named_span

        inputs, prompt_len = self._inputs(batch)
        self._check_capacity(prompt_len, n_tokens)
        generator = self._generator(generator)
        buf = self._buffers(inputs["tokens"].shape[0])
        logits, _ = self._prefill(inputs, out=buf.rows())
        buf.replicate()
        buf.start(self._first_token(logits, generator, sampling))
        if n_tokens > 1:
            buf.reset_diag()
            with named_span("serve.decode_scan"):
                self._decode(buf, n_tokens - 1, generator, sampling,
                             self.graphs)
            if self._diag:
                self._drain_diag(buf)
        toks = buf.out[:n_tokens].t().contiguous()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return toks

    @torch.inference_mode()
    def generate_python_loop(self, batch, n_tokens: int,
                             sampling: Sampling = GREEDY,
                             generator: Optional[torch.Generator] = None):
        """Same semantics as ``generate``, decoded eagerly one step at a
        time from the host (every kernel of every step a launch of its
        own): the baseline ``generate``'s replays are held against."""
        caches, tok, generator = self._start(batch, n_tokens, sampling,
                                             generator)
        out = [tok]
        if self._replicated and n_tokens > 1:
            caches = R.flatten_replicas(
                R.stack_replicas(caches, self.robust.m), self.robust.m)
        for _ in range(n_tokens - 1):
            tok, caches, _ = self._decode_step(tok, caches, generator,
                                               sampling)
            out.append(tok)
        return torch.stack(out, dim=1)

    # -- slot-pool path (continuous batching) -------------------------------

    def make_pool(self) -> C.SlotPool:
        """An empty pool of ``n_slots`` slots on the engine's device (m
        replica rows a slot when the replicas run replicated)."""
        return C.init_pool(self.cfg, self.n_slots, self.max_len,
                           window=self.window, m=self._m, device=self.device)

    @torch.inference_mode()
    def admit(self, pool: C.SlotPool, slot: int, batch,
              sampling: Sampling = GREEDY,
              generator: Optional[torch.Generator] = None):
        """Prefill one request (batch dim 1) into ``slot``, in place.

        Runs while the other slots hold live, partially decoded sequences;
        their rows are untouched. The prefill runs eagerly (B2 on the card,
        at the request's prompt length). Returns (pool, the first sampled
        token as a python int, which reads the device once). ``generator``
        None seeds a fresh one with the slot, as ``repro`` keys it."""
        from ..obs.trace import trace_span

        with trace_span("serve.admit"):
            inputs, prompt_len = self._inputs(batch)
            n = inputs["tokens"].shape[0]
            if n != 1:
                raise ValueError(f"admit() takes one request, got batch {n}")
            if prompt_len >= self.max_len:
                raise ValueError(f"prompt ({prompt_len}) must leave decode "
                                 f"room in max_len ({self.max_len})")
            generator = self._generator(generator, seed=int(slot))
            logits, caches = self._prefill(inputs)
            C.write_slot(pool, caches, slot, prompt_len)
            tok = self._first_token(logits, generator, sampling)
            return pool, int(tok[0])

    def _pool_buffers(self, pool: C.SlotPool) -> DecodeBuffers:
        """The step buffers over ``pool``'s caches; another pool replaces
        them and drops the steps captured over them."""
        buf = self.pool_buffers
        if buf is None or buf.caches.pos is not pool.caches.pos:
            self.pool_graphs.clear()
            self.pool_buffers = None
            buf = DecodeBuffers(self.cfg, pool.n_slots, pool.m, self.max_len,
                                None, self.device, caches=pool.caches,
                                diag=self._diag)
            buf.active = pool.active
            self.pool_buffers = buf
        return buf

    @torch.inference_mode()
    def decode_pool(self, pool: C.SlotPool, cur_tok, n_steps: int,
                    sampling: Sampling = GREEDY,
                    generator: Optional[torch.Generator] = None):
        """Advance every slot ``n_steps`` tokens.

        cur_tok: [n_slots] — each slot's last token (a free slot carries a
        dummy; it decodes stale rows and its output is dropped by the
        scheduler). On the card the pool's step is captured once per
        sampling config (``self.pool_graphs``) over the pool's own tensors
        and replayed ``n_steps`` times, one graph launch a token; the first
        step of a new config runs eagerly, as in ``generate``. ``lengths``
        advance where ``active``. Returns (pool, toks [n_steps, n_slots]
        int32 on the device, copied out of the step's buffers)."""
        from ..obs.trace import trace_span

        with trace_span("serve.decode_pool"):
            if not 1 <= n_steps <= self.max_len:
                raise ValueError(f"n_steps {n_steps} outside 1..max_len "
                                 f"{self.max_len}")
            buf = self._pool_buffers(pool)
            generator = self._generator(generator)
            buf.tok.copy_(cur_tok if torch.is_tensor(cur_tok)
                          else torch.from_numpy(np.asarray(cur_tok)))
            buf.t.zero_()
            buf.reset_diag()
            self._decode(buf, n_steps, generator, sampling, self.pool_graphs)
            pool.lengths.add_(pool.active, alpha=n_steps)
            toks = buf.out[:n_steps].clone()
            if self._diag:
                self._drain_diag(buf)
            return pool, toks

    def evict(self, pool: C.SlotPool, slot: int) -> C.SlotPool:
        return C.evict_slot(pool, slot)
