"""Synthetic data. Only the GLM simulation data of the paper's Section 4
is ported (``Shards`` / ``make_shards`` / ``paper_theta_star``, re-exported
from :mod:`core.rcsl`); the LM token streams come with training
(ROADMAP.md, queue A4)."""
from ..core.rcsl import Shards, make_shards, paper_theta_star

__all__ = ["Shards", "make_shards", "paper_theta_star"]
