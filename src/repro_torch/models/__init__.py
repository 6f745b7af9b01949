"""Model zoo, dense family: layers, attention, backend policy, the decoder
stack and the model API."""
from . import attention, attn_backend, layers, model, transformer
from .model import decode_step, init, init_cache, prefill

__all__ = ["attention", "attn_backend", "layers", "model", "transformer",
           "decode_step", "init", "init_cache", "prefill"]
