"""Serving: the prefill + decode engine with Byzantine-robust replicated
decoding. The slot pool and scheduler of ``repro.serve`` come in a later
slice (ROADMAP.md, queue A)."""
from .engine import GREEDY, Sampling, ServeEngine, sample_tokens
from .robust import RobustDecodeConfig, replica_mask, robust_logits

__all__ = ["ServeEngine", "Sampling", "GREEDY", "sample_tokens",
           "RobustDecodeConfig", "replica_mask", "robust_logits"]
