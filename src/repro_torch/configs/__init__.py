"""Ported architecture configs. ``get(name)``."""
from . import qwen3_1_7b
from .base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (qwen3_1_7b,)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet (see "
                       f"ROADMAP.md, queue A); ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "get"]
