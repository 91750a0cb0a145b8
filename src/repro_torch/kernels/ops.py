"""The public ops backed by the kernels.

:func:`cost_matrix_sparse_kernel` is Alg. 1 on the pooled-lookup kernel
(counterpart of the reference's ``kernels/ops.py:
cost_matrix_pallas_sparse``): per-id cost rows are built only for the
batch's unique ids (a compact ``(U, n)`` table, U = k * F with the
padding rows zero) and :func:`repro_torch.kernels.emb_lookup.
pooled_lookup` pools it over the remapped ids, so the kernel never sees
the vocabulary.  On CUDA tensors that is the B1 kernel; on CPU tensors
its plain version, which sums in the same order.

:func:`auction_solve_kernel` is the counterpart of the reference's
``auction_solve_pallas`` (whose bid phase runs in the Pallas kernel): the
same solver as :func:`repro_torch.core.auction.auction_solve`, on the
fused auction kernel, with one terminal phase at the final eps, as the
reference's has.
"""
from __future__ import annotations

import torch

from ..core.auction import _solve
from ..core.cost import dedup_mask, per_id_cost_rows, unique_padded
from .emb_lookup import pooled_lookup

__all__ = ["cost_table_sparse", "cost_matrix_sparse_kernel",
           "auction_solve_kernel"]


def cost_table_sparse(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                      dirty: torch.Tensor, t_tran: torch.Tensor):
    """The pooled lookup's inputs for Alg. 1: the compact (U, n) per-id
    cost table, the (k, F) int32 ids remapped into it and the (k, F) f32
    dedup weights (0 for PAD and repeated ids)."""
    V = latest_in_cache.shape[1]
    ids, mask = dedup_mask(samples)
    w = mask.to(torch.float32)
    # compact sorted id universe (pad sentinel V, masked out of the table)
    uids = unique_padded(torch.where(mask, ids, V).reshape(-1), V)
    uvalid = uids < V
    g = uids.clamp(max=V - 1).long()
    lat_u = latest_in_cache[:, g] & uvalid[None, :]             # (n, U)
    dirty_u = dirty[:, g] & uvalid[None, :]
    table = per_id_cost_rows(lat_u, dirty_u, t_tran)             # (U, n)
    inv = torch.searchsorted(uids, ids).clamp(max=uids.shape[0] - 1)
    return table.contiguous(), inv.to(torch.int32), w.contiguous()


def cost_matrix_sparse_kernel(samples: torch.Tensor,
                              latest_in_cache: torch.Tensor,
                              dirty: torch.Tensor,
                              t_tran: torch.Tensor) -> torch.Tensor:
    """Touched-ids Alg. 1: (k, F) samples, (n, V) state planes and (n,)
    link times -> (k, n) f32 cost matrix."""
    return pooled_lookup(*cost_table_sparse(samples, latest_in_cache, dirty,
                                            t_tran))


def auction_solve_kernel(cost: torch.Tensor, capacity: int,
                         eps: float = 1e-3, max_rounds: int = 500_000,
                         scaling: float = 6.0):
    """Same contract as :func:`repro_torch.core.auction.auction_solve`,
    with one phase at the final eps.  cost: (k, n) on the device to solve
    on.  Returns (assign (k,) int32, rounds)."""
    return _solve(cost.to(torch.float32), capacity, eps, max_rounds,
                  scaling, n_final=1)
