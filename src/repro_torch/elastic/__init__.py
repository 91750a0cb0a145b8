"""repro_torch.elastic — fault-injected elastic edge cluster (the
counterpart of the JAX package's ``elastic``).

Churn, stragglers, bandwidth droop, and PS-shard outages as declarative
:class:`FaultPlan` events; elastic membership threaded through the
dispatch stages at fixed shapes; cache handoff on departure and
rejoin; checkpointed recovery of dispatch state.
"""
from .faults import ClusterState, FaultEvent, FaultPlan, effective_t
from .membership import (HandoffPlan, cost_column_bias, departure_handoff,
                         mask_state, rejoin_handoff)
from .recovery import gap_bound, replay_dispatch

__all__ = [
    "FaultEvent", "FaultPlan", "ClusterState", "effective_t",
    "cost_column_bias", "mask_state", "HandoffPlan",
    "departure_handoff", "rejoin_handoff",
    "replay_dispatch", "gap_bound",
]
