"""Model zoo, dense, vlm and moe families: layers, attention, backend
policy, the mixture of experts, the decoder stack and the model API."""
from . import attention, attn_backend, layers, model, moe, transformer
from .model import decode_step, init, init_cache, prefill

__all__ = ["attention", "attn_backend", "layers", "model", "moe",
           "transformer",
           "decode_step", "init", "init_cache", "prefill"]
