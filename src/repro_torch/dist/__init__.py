"""Robust reduction over emulated workers on one card: the stacked
aggregate, its adaptive tier with the ``AdaptiveState`` carry, the
in-backward ``robust_dot`` and its context, the symmetric-stack aggregate
of the inference layer, and the decentralized consensus backend
(``consensus``: the peer-to-peer emulation, under the failures of a
``faults.FaultPlan``). The RRS all-to-all wire and ``repro``'s
``shard_map`` consensus wire come with multi-card training (ROADMAP.md,
A5)."""
from . import consensus, faults
from .consensus import (ConsensusAux, ConsensusConfig, consensus_aggregate,
                        consensus_iterate)
from .faults import FaultPlan
from .robust_reduce import (aggregate, aggregate_stacked_adaptive,
                            aggregate_stacked_auto,
                            aggregate_symmetric_stacked, robust_backward,
                            robust_dot, robust_dot_enabled)

__all__ = ["aggregate", "aggregate_stacked_adaptive",
           "aggregate_stacked_auto", "aggregate_symmetric_stacked",
           "robust_backward", "robust_dot", "robust_dot_enabled",
           "consensus", "faults", "ConsensusAux", "ConsensusConfig",
           "consensus_aggregate", "consensus_iterate", "FaultPlan"]
