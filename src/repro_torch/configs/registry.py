"""Registry of the ported architectures (``repro.configs.registry``'s
counterpart): ``ARCHS``, ``get(name)``, ``list_archs()``. The port holds
every architecture ``repro`` registers."""
from . import (granite_moe_3b_a800m, llama3_405b, mamba2_2_7b, minitron_4b,
               mixtral_8x7b, phi_3_vision_4_2b, qwen3_1_7b, starcoder2_7b,
               whisper_medium, zamba2_7b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_1_7b, starcoder2_7b, phi_3_vision_4_2b,
              granite_moe_3b_a800m, minitron_4b, mixtral_8x7b, llama3_405b,
              mamba2_2_7b, zamba2_7b, whisper_medium)
}


def get(name: str):
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown architecture {name!r}; ported: "
                   f"{list_archs()}")


def list_archs():
    return sorted(ARCHS)
