"""Registry of the ported architectures (``repro.configs.registry``'s
counterpart): ``ARCHS``, ``get(name)``, ``list_archs()``.

``repro`` registers ten architectures; the port holds the dense, vlm,
moe, ssm and hybrid ones. whisper-medium needs the encdec family, which
is not ported yet, and asking for it raises, naming the family and
ROADMAP.md's item for it."""
from . import (granite_moe_3b_a800m, llama3_405b, mamba2_2_7b, minitron_4b,
               mixtral_8x7b, phi_3_vision_4_2b, qwen3_1_7b, starcoder2_7b,
               zamba2_7b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_1_7b, starcoder2_7b, phi_3_vision_4_2b,
              granite_moe_3b_a800m, minitron_4b, mixtral_8x7b, llama3_405b,
              mamba2_2_7b, zamba2_7b)
}

# repro's other architectures, by the family each one waits on
NOT_PORTED = {
    "whisper-medium": "encdec",
}


def get(name: str):
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} needs the {NOT_PORTED[name]} family, "
            f"which is not ported yet (see ROADMAP.md, A7)")
    raise KeyError(f"unknown architecture {name!r}; ported: "
                   f"{list_archs()}")


def list_archs():
    return sorted(ARCHS)
