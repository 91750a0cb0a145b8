"""ESD core: Alg. 1, Alg. 2, the cache protocol and the simulator.

Host-side numpy copied from the JAX package (the simulator, its cache
engines and baselines, the greedy and exact solvers), the eps-scaled
auction solved whole in a CUDA kernel, and the training step's decide
stage and cache state in PyTorch (:mod:`.dispatch`).

Exports what the reference's ``core`` exports, under the port's names
for its PyTorch counterparts: ``dedup_mask`` and ``cost_matrix_sparse``
are the torch twins of ``dedup_mask_jnp`` and ``cost_matrix_sparse_jnp``,
and the reference's numpy ``cost_matrix_sparse`` and
``cost_matrix_sparse_ps`` are ``cost_matrix_sparse_np`` and
``cost_matrix_sparse_ps_np`` here.  Not ported yet: the dense
``cost_matrix_jnp`` (ROADMAP A4) and the device-side multi-PS
``per_id_cost_rows_ps`` / ``cost_matrix_sparse_ps_jnp`` (ROADMAP A2).
"""
from .auction import auction_dispatch, auction_solve
from .baselines import FAECache, HETCache, laia_dispatch, random_dispatch
from .cache import ClusterCache, IterStats, SparseClusterCache
from .cost import (
    batch_unique_np, cost_from_state_cols, cost_from_state_cols_ps,
    cost_matrix_np, cost_matrix_sparse, cost_matrix_sparse_np,
    cost_matrix_sparse_ps_np, dedup_mask, dedup_mask_np, per_id_cost_rows,
    transmission_time,
)
from .heu import heu_dispatch, min2_minus_min
from .hungarian import assignment_cost, expand_capacity, hungarian, hungarian_dispatch
from .hybrid import hybrid_dispatch
from .simulator import (DEFAULT_BANDWIDTHS, SimConfig, SimResult,
                        hetero_ps_bandwidths, simulate)

__all__ = [
    "auction_dispatch", "auction_solve", "FAECache", "HETCache",
    "laia_dispatch", "random_dispatch", "ClusterCache", "SparseClusterCache",
    "IterStats", "cost_matrix_np", "cost_matrix_sparse",
    "cost_matrix_sparse_np", "batch_unique_np", "cost_from_state_cols",
    "cost_from_state_cols_ps", "cost_matrix_sparse_ps_np",
    "dedup_mask", "dedup_mask_np", "per_id_cost_rows",
    "transmission_time", "heu_dispatch", "min2_minus_min",
    "assignment_cost", "expand_capacity", "hungarian", "hungarian_dispatch",
    "hybrid_dispatch", "DEFAULT_BANDWIDTHS", "SimConfig", "SimResult",
    "simulate", "hetero_ps_bandwidths",
]
