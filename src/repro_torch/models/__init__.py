"""Model zoo, dense, vlm, moe, ssm, hybrid and encdec families: layers,
attention, backend policy, the mixture of experts, the mamba2 block, the
decoder stack, the hybrid stack, the whisper encoder-decoder and the model
API."""
from . import (attention, attn_backend, caches, hybrid, layers, mamba2,
               model, moe, transformer, whisper)
from .model import decode_step, init, init_cache, prefill

__all__ = ["attention", "attn_backend", "caches", "hybrid", "layers",
           "mamba2", "model", "moe", "transformer", "whisper",
           "decode_step", "init", "init_cache", "prefill"]
