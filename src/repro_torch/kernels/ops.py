"""The public ops backed by the kernels.

:func:`cost_matrix_sparse_kernel` is Alg. 1 on the pooled-lookup kernel
(counterpart of the reference's ``kernels/ops.py:
cost_matrix_pallas_sparse``): per-id cost rows are built only for the
batch's unique ids (a compact ``(U, n)`` table, U = k * F with the
padding rows zero) and :func:`repro_torch.kernels.emb_lookup.
pooled_lookup` pools it over the remapped ids, so the kernel never sees
the vocabulary.  On CUDA tensors that is the B1 kernel; on CPU tensors
its plain version, which sums in the same order.

:func:`cost_matrix_batched_kernel` is the same Alg. 1 for all n workers
in one launch of :func:`repro_torch.kernels.emb_lookup.alg1_cost`, which
prices each kept id straight from the state planes and pools in f
order: ``torch.stack`` of :func:`cost_matrix_sparse_kernel` over the
workers, bit for bit, with no compaction, no per-id table and no
per-worker loop.

:func:`cost_matrix_sparse_ps_kernel` is the multi-PS Alg. 1 on the same
kernel: the compact table's rows are priced at each id's owning shard's
link (:func:`repro_torch.core.cost.per_id_cost_rows_ps` at ``t_cols =
t_ps[:, shard_of_linear(uids)]``).  The reference has no Pallas form of
it and computes ``cost_matrix_sparse_ps_jnp`` instead: the same per-id
values, summed over a sample's slots in XLA's order, so the two differ
in the last bit.  :func:`cost_matrix_kernel` (the reference's
``cost_matrix_pallas``) pools the dense (V, n) per-id table over the
samples' own ids: the same per-id values in the same order, so it gives
the compact route's bits.

:func:`auction_solve_kernel` is the counterpart of the reference's
``auction_solve_pallas`` (whose bid phase runs in the Pallas kernel): the
same solver as :func:`repro_torch.core.auction.auction_solve`, on the
fused auction kernel, with one terminal phase at the final eps, as the
reference's has.
"""
from __future__ import annotations

import torch

from ..core.auction import _solve
from ..core.cost import (dedup_mask, per_id_cost_rows, per_id_cost_rows_ps,
                         unique_padded)
from .emb_lookup import ALG1_MAX_WORKERS, alg1_cost, pooled_lookup

__all__ = ["cost_table_sparse", "cost_matrix_sparse_kernel",
           "cost_matrix_batched_kernel",
           "cost_table_sparse_ps", "cost_matrix_sparse_ps_kernel",
           "cost_table_dense", "cost_matrix_kernel", "auction_solve_kernel"]


def _compact(samples: torch.Tensor, latest_in_cache: torch.Tensor,
             dirty: torch.Tensor):
    """The batch's compact id universe: (ids, w, uids, g, lat_u, dirty_u)
    — the deduplicated ids and their f32 weights, the sorted unique ids
    (pad sentinel V), their in-bounds columns and the (n, U) state there
    (pad columns cleared)."""
    V = latest_in_cache.shape[1]
    ids, mask = dedup_mask(samples)
    uids = unique_padded(torch.where(mask, ids, V).reshape(-1), V)
    uvalid = uids < V
    g = uids.clamp(max=V - 1).long()
    lat_u = latest_in_cache[:, g] & uvalid[None, :]             # (n, U)
    dirty_u = dirty[:, g] & uvalid[None, :]
    return ids, mask.to(torch.float32), uids, g, lat_u, dirty_u


def _remap(table, ids, w, uids):
    inv = torch.searchsorted(uids, ids).clamp(max=uids.shape[0] - 1)
    return table.contiguous(), inv.to(torch.int32), w.contiguous()


def cost_table_sparse(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                      dirty: torch.Tensor, t_tran: torch.Tensor):
    """The pooled lookup's inputs for Alg. 1: the compact (U, n) per-id
    cost table, the (k, F) int32 ids remapped into it and the (k, F) f32
    dedup weights (0 for PAD and repeated ids)."""
    ids, w, uids, _, lat_u, dirty_u = _compact(samples, latest_in_cache,
                                               dirty)
    return _remap(per_id_cost_rows(lat_u, dirty_u, t_tran), ids, w, uids)


def cost_matrix_sparse_kernel(samples: torch.Tensor,
                              latest_in_cache: torch.Tensor,
                              dirty: torch.Tensor,
                              t_tran: torch.Tensor) -> torch.Tensor:
    """Touched-ids Alg. 1: (k, F) samples, (n, V) state planes and (n,)
    link times -> (k, n) f32 cost matrix."""
    return pooled_lookup(*cost_table_sparse(samples, latest_in_cache, dirty,
                                            t_tran))


def cost_matrix_batched_kernel(samples: torch.Tensor,
                               latest_in_cache: torch.Tensor,
                               dirty: torch.Tensor,
                               t_tran: torch.Tensor):
    """Touched-ids Alg. 1 for every worker in one launch: (n, m, F)
    samples, (n, V) bool state planes and (n,) link times -> (n, m, n)
    f32, worker i's block the (m, n) matrix of
    :func:`cost_matrix_sparse_kernel` on ``samples[i]``, bit for bit.
    None where n is more than the kernel's lanes take
    (:data:`repro_torch.kernels.emb_lookup.ALG1_MAX_WORKERS`)."""
    if samples.shape[0] > ALG1_MAX_WORKERS:
        return None
    return alg1_cost(samples.to(torch.int32).contiguous(), latest_in_cache,
                     dirty, t_tran.to(torch.float32).contiguous())


def cost_table_sparse_ps(samples: torch.Tensor,
                         latest_in_cache: torch.Tensor, dirty: torch.Tensor,
                         t_ps: torch.Tensor, part):
    """:func:`cost_table_sparse` with per-shard link costs: samples and
    planes in ``part``'s PS-linearized space, ``t_ps`` (n, n_ps); each
    unique id's row priced at its owning shard's links."""
    ids, w, uids, g, lat_u, dirty_u = _compact(samples, latest_in_cache,
                                               dirty)
    t_cols = t_ps.to(torch.float32)[:, part.shard_of_linear(g)]   # (n, U)
    return _remap(per_id_cost_rows_ps(lat_u, dirty_u, t_cols), ids, w, uids)


def cost_matrix_sparse_ps_kernel(samples: torch.Tensor,
                                 latest_in_cache: torch.Tensor,
                                 dirty: torch.Tensor, t_ps: torch.Tensor,
                                 part) -> torch.Tensor:
    """Touched-ids multi-PS Alg. 1: (k, F) PS-linearized samples, (n, V)
    state planes of width ``part.linear_size`` and (n, n_ps) link times
    -> (k, n) f32 cost matrix."""
    return pooled_lookup(*cost_table_sparse_ps(samples, latest_in_cache,
                                               dirty, t_ps, part))


def cost_table_dense(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                     dirty: torch.Tensor, t_tran: torch.Tensor):
    """The pooled lookup's inputs for the dense Alg. 1: the (V, n) per-id
    cost table over the whole vocabulary, the samples' own ids (PAD
    clamped to 0) as int32 and the (k, F) f32 dedup weights."""
    ids, mask = dedup_mask(samples)
    table = per_id_cost_rows(latest_in_cache, dirty, t_tran)      # (V, n)
    return (table.contiguous(), ids.to(torch.int32).contiguous(),
            mask.to(torch.float32).contiguous())


def cost_matrix_kernel(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                       dirty: torch.Tensor, t_tran: torch.Tensor
                       ) -> torch.Tensor:
    """Alg. 1 as one pooled lookup of the dense (V, n) per-id table:
    (k, F) samples, (n, V) state planes and (n,) link times -> (k, n)
    f32 cost matrix."""
    return pooled_lookup(*cost_table_dense(samples, latest_in_cache, dirty,
                                           t_tran))


def auction_solve_kernel(cost: torch.Tensor, capacity: int,
                         eps: float = 1e-3, max_rounds: int = 500_000,
                         scaling: float = 6.0):
    """Same contract as :func:`repro_torch.core.auction.auction_solve`,
    with one phase at the final eps.  cost: (k, n) on the device to solve
    on.  Returns (assign (k,) int32, rounds)."""
    return _solve(cost.to(torch.float32), capacity, eps, max_rounds,
                  scaling, n_final=1)
