"""Ported architecture configs. ``get(name)`` / ``list_archs()``."""
from .base import ArchConfig, MoEConfig, SSMConfig, VisionStubConfig
from .registry import ARCHS, get, list_archs

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "VisionStubConfig",
           "ARCHS", "get", "list_archs"]
