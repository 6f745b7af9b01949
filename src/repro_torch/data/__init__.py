"""Synthetic data for training and for the statistical experiments.

* **LM token streams** (``lm_batch`` / ``lm_stream``): deterministic,
  counter-indexed batches of a noisy integer AR process, computed with
  numpy from ``(seed, step)`` alone, exactly as ``repro.data`` computes
  them: every config gets ``repro``'s tokens bit for bit, and a vlm's
  stub patches or an encdec model's stub frames from the same draws, so
  a run restored from a checkpointed step resumes on the data it would
  have seen. A vlm's ``patches`` take the front of the sequence and
  shorten ``tokens`` to fit; an encdec model's ``frames`` go to its
  encoder. There is no ``shard_batch``: on one card the train step splits the batch over its
  workers itself.
* **GLM simulation data** of the paper's Section 4: ``Shards`` /
  ``make_shards`` / ``paper_theta_star``, re-exported from
  :mod:`core.rcsl`.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..core.rcsl import Shards, make_shards, paper_theta_star
from ..device import resolve_device

__all__ = ["lm_batch", "lm_stream", "Shards", "make_shards",
           "paper_theta_star"]


def lm_batch(cfg, step: int, batch: int, seq: int, seed: int = 0,
             device=None):
    """``{"tokens": [batch, seq] int32}`` (and ``"patches"`` [batch,
    n_patches, d_model] in the compute dtype for a vlm, whose tokens are
    then ``seq - n_patches`` long; ``"frames"`` [batch, n_frames, d_model]
    in the compute dtype for an encdec model) on ``device``: the card
    unless the caller names another."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    drift = rng.integers(1, 7, size=(batch, 1))
    start = rng.integers(0, cfg.vocab, size=(batch, 1))
    noise = rng.integers(0, 3, size=(batch, seq))
    toks = (start + drift * np.arange(seq)[None, :] + noise) % cfg.vocab
    toks = toks.astype(np.int32)
    out = {}

    def stub(n):
        x = rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x).to(device=device,
                                      dtype=getattr(torch, cfg.compute_dtype))

    if cfg.family == "encdec":
        out["frames"] = stub(cfg.encoder.n_frames)
    elif cfg.family == "vlm":
        out["patches"] = stub(cfg.vision.n_patches)
        toks = toks[:, : seq - cfg.vision.n_patches]
    out["tokens"] = torch.from_numpy(np.ascontiguousarray(toks)).to(device)
    return out


def lm_stream(cfg, batch: int, seq: int, seed: int = 0, start_step: int = 0,
              device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, batch, seq, seed, device=device)
        step += 1
