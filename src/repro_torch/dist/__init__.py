"""Robust reduction: the stacked aggregate over workers emulated on one
card or held by the ranks of a process group (the RRS wire,
``aggregate_stacked_rrs``), its adaptive tier with the ``AdaptiveState``
carry, the in-backward ``robust_dot`` and its context, the symmetric-stack
aggregate of the inference layer, the decentralized consensus backend
(``consensus``: the peer-to-peer emulation, under the failures of a
``faults.FaultPlan``, and ``aggregate_stacked_consensus``, its wire over
the ranks of a process group, one peer a rank), and the mesh spec layer
(``sharding``, ``ctx``'s ``mesh_context``)."""
from . import consensus, faults
from .consensus import (ConsensusAux, ConsensusConfig,
                        aggregate_stacked_consensus, consensus_aggregate,
                        consensus_iterate)
from .faults import FaultPlan
from .robust_reduce import (GroupRefusal, aggregate,
                            aggregate_stacked_adaptive,
                            aggregate_stacked_auto, aggregate_stacked_rrs,
                            aggregate_symmetric_stacked, robust_backward,
                            robust_dot, robust_dot_enabled)

__all__ = ["aggregate", "aggregate_stacked_adaptive",
           "aggregate_stacked_auto", "aggregate_stacked_rrs", "GroupRefusal",
           "aggregate_symmetric_stacked", "robust_backward", "robust_dot", "robust_dot_enabled",
           "consensus", "faults", "ConsensusAux", "ConsensusConfig",
           "aggregate_stacked_consensus", "consensus_aggregate", "consensus_iterate", "FaultPlan"]
