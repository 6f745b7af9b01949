"""Serving: continuous batching with Byzantine-robust replicated decoding
(``repro.serve``'s port).

    cache      slot pool (per-slot lengths, admit/evict in place)
    engine     prefill + the decode step replayed as a CUDA graph + sampling
    scheduler  continuous batching: queue, mid-decode admission, retirement
    robust     m-replica decode with robust logit aggregation + attacks
"""
from .cache import SlotPool, evict_slot, init_pool, write_slot
from .engine import GREEDY, Sampling, ServeEngine, sample_tokens
from .robust import RobustDecodeConfig, replica_mask, robust_logits
from .scheduler import Completion, Request, Scheduler

__all__ = [
    "SlotPool", "init_pool", "write_slot", "evict_slot",
    "ServeEngine", "Sampling", "GREEDY", "sample_tokens",
    "RobustDecodeConfig", "replica_mask", "robust_logits",
    "Request", "Completion", "Scheduler",
]
