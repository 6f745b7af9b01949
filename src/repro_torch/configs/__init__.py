"""Ported architecture configs. ``get(name)`` / ``list_archs()``."""
from .base import ArchConfig, VisionStubConfig
from .registry import ARCHS, get, list_archs

__all__ = ["ArchConfig", "VisionStubConfig", "ARCHS", "get", "list_archs"]
