"""Robust reduction wires. Only the symmetric-stack aggregate of the
inference layer is ported; the stacked, RRS and consensus wires come with
training and multi-rank (ROADMAP.md, queue A)."""
from .robust_reduce import aggregate_symmetric_stacked

__all__ = ["aggregate_symmetric_stacked"]
