"""Robust reduction over emulated workers on one card: the stacked
aggregate, its adaptive tier with the ``AdaptiveState`` carry, the
in-backward ``robust_dot`` and its context, and the symmetric-stack
aggregate of the inference layer. The RRS all-to-all wire comes with
multi-card training (ROADMAP.md, A5), the consensus backend with A6b."""
from .robust_reduce import (aggregate, aggregate_stacked_adaptive,
                            aggregate_stacked_auto,
                            aggregate_symmetric_stacked, robust_backward,
                            robust_dot, robust_dot_enabled)

__all__ = ["aggregate", "aggregate_stacked_adaptive",
           "aggregate_stacked_auto", "aggregate_symmetric_stacked",
           "robust_backward", "robust_dot", "robust_dot_enabled"]
