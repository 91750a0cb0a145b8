"""The spec layer: the mesh context (attention-mode selection, in-model
constraints, the MoE dispatch knobs) and the sharding rules for
parameters, optimizer state, batches and decode caches.

The counterpart of the JAX package's ``dist``.  The DLRM table's PS-row
placement (flat (V, E), or PS-stacked (n_ps, max_rows, E) in the
:mod:`repro_torch.ps` (shard, local_row) convention) and the LM
tensor-parallel placements both come out of ``sharding.param_specs``.
The port computes on one card: the specs feed the dry run's per-device
bytes (:mod:`repro_torch.launch.dryrun`), and placing tensors on a mesh
of more than one device is ROADMAP A14.9's multi-device placement,
which one card cannot give.
"""
from . import ctx, sharding
from .sharding import (
    batch_specs,
    cache_specs,
    data_axes,
    opt_state_specs,
    param_specs,
    to_shardings,
    zero1_specs,
)

__all__ = [
    "ctx", "sharding", "param_specs", "opt_state_specs", "batch_specs",
    "cache_specs", "data_axes", "zero1_specs", "to_shardings",
]
