"""Ported architecture configs. ``get(name)`` / ``list_archs()``."""
from .base import (ArchConfig, EncoderConfig, MoEConfig, SSMConfig,
                   VisionStubConfig)
from .registry import ARCHS, get, list_archs

__all__ = ["ArchConfig", "EncoderConfig", "MoEConfig", "SSMConfig",
           "VisionStubConfig", "ARCHS", "get", "list_archs"]
