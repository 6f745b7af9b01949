"""Ported architecture configs. ``get(name)`` / ``list_archs()``; the
dry-run's input shapes and their stand-ins (``INPUT_SHAPES``,
``input_specs``)."""
from .base import (INPUT_SHAPES, ArchConfig, EncoderConfig, InputShape,
                   MoEConfig, SSMConfig, VisionStubConfig, input_specs)
from .registry import ARCHS, get, list_archs

__all__ = ["ArchConfig", "EncoderConfig", "InputShape", "INPUT_SHAPES",
           "MoEConfig", "SSMConfig", "VisionStubConfig", "ARCHS", "get",
           "input_specs", "list_archs"]
