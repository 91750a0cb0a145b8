"""Alg. 1 — the expected-cost module.

Numpy (copied from the JAX package's ``core/cost.py``, bit for bit, so
both packages price alike): per-link row transmission time, fp32 or
under per-link wire codecs; the simulator's Alg. 1 — dense
(:func:`cost_matrix_np`), touched-ids (:func:`cost_from_state_cols`,
:func:`cost_matrix_sparse_np`) and multi-PS
(:func:`cost_from_state_cols_ps`, :func:`cost_matrix_sparse_ps_np`) —
and the serving path's pull-only cost column.  The reference names its
numpy touched-ids functions ``cost_matrix_sparse`` and
``cost_matrix_sparse_ps``; here they carry an ``_np`` suffix, because
:func:`cost_matrix_sparse` is the PyTorch counterpart of the
reference's ``cost_matrix_sparse_jnp``.

PyTorch (the training step's decide stage): the per-sample id dedup, the
per-id cost rows and the plain Alg. 1 — touched-ids, multi-PS and dense
— counterparts of the reference's ``dedup_mask_jnp``,
``per_id_cost_rows``, ``per_id_cost_rows_ps``, ``cost_matrix_sparse_jnp``,
``cost_matrix_sparse_ps_jnp`` and ``cost_matrix_jnp``.  The decide stage
itself prices through the pooled-lookup kernel
(:mod:`repro_torch.kernels.ops`); :func:`cost_matrix_sparse`,
:func:`cost_matrix_sparse_ps` and :func:`cost_matrix_dense` are the
reference's second formulas, kept for comparison.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PAD_ID", "transmission_time", "transmission_time_codec",
           "dedup_mask_np", "cost_matrix_np", "batch_unique_np",
           "cost_from_state_cols", "cost_matrix_sparse_np",
           "cost_from_state_cols_ps", "cost_matrix_sparse_ps_np",
           "miss_time_from_state_cols",
           "dedup_mask", "unique_padded", "per_id_cost_rows",
           "cost_matrix_sparse", "per_id_cost_rows_ps",
           "cost_matrix_sparse_ps", "cost_matrix_dense"]

PAD_ID = -1  # padding slot inside a sample's id list


def transmission_time(d_tran_bytes: float, bandwidth_bytes_per_s: np.ndarray) -> np.ndarray:
    """T_j = D_tran / B_j (paper Table 1)."""
    return np.asarray(d_tran_bytes, np.float64) / np.asarray(bandwidth_bytes_per_s, np.float64)


def transmission_time_codec(n_elems: int, bandwidth_bytes_per_s: np.ndarray,
                            link_codecs=None) -> np.ndarray:
    """Per-link row transmission time for an ``n_elems``-wide embedding
    row under per-link wire codecs — Alg. 1's T_j with the byte width
    folded in.

    ``link_codecs`` is what :func:`repro_torch.quant.codecs.
    resolve_link_codecs` returns: ``None`` (every link fp32 — bitwise
    identical to ``transmission_time(n_elems * 4.0, bw)``) or an array
    of codec names shaped like ``bandwidth_bytes_per_s`` ((n,) or
    (n, n_ps)).  A quantized link is charged payload + scale/zero-point
    metadata (:func:`repro_torch.quant.codecs.row_wire_bytes`).
    """
    bw = np.asarray(bandwidth_bytes_per_s, np.float64)
    if link_codecs is None:
        return transmission_time(n_elems * 4.0, bw)
    from ..quant.codecs import row_wire_bytes

    codecs = np.asarray(link_codecs, object)
    if codecs.shape != bw.shape:
        raise ValueError(f"link_codecs shape {codecs.shape} != "
                         f"bandwidth shape {bw.shape}")
    byte_of = {}
    flat = codecs.reshape(-1)
    d = np.empty(flat.shape, np.float64)
    for i, name in enumerate(flat):
        if name not in byte_of:
            byte_of[name] = float(row_wire_bytes(n_elems, name))
        d[i] = byte_of[name]
    return d.reshape(bw.shape) / bw


def dedup_mask_np(samples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ids, mask): PAD clamped to 0 (for safe gathers), mask keeps the
    first occurrence of each id within every sample.

    Dedup runs on the raw values so PAD slots (-1) group separately from
    a real id 0."""
    samples = np.asarray(samples)
    valid = samples != PAD_ID
    ids = np.where(valid, samples, 0)
    sort_idx = np.argsort(samples, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(samples, sort_idx, axis=1)
    first = np.ones_like(sorted_ids, dtype=bool)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    dedup = np.zeros_like(first)
    np.put_along_axis(dedup, sort_idx, first, axis=1)
    return ids, valid & dedup


def _cost_from_gathers(latest_g: np.ndarray, dirty_g: np.ndarray,
                       valid: np.ndarray, t_tran: np.ndarray) -> np.ndarray:
    """Alg. 1 arithmetic on (n, k, F) gathered state.

    Shared by the dense and sparse numpy paths — same operations in the
    same order, so the two are *bitwise* equal (assignment tie-breaks
    downstream see identical costs).
    """
    # miss pull
    miss = (~latest_g) & valid[None, :, :]        # (n, k, F)
    miss_cost = miss.sum(axis=2).T * t_tran[None, :]   # (k, n)

    # update push: cost of other dirty holders pushing to the PS.
    push_any = (dirty_g * t_tran[:, None, None]).sum(axis=0)   # (k, F) total push cost of all holders
    push_any = np.where(valid, push_any, 0.0)
    # subtract the self-term: if w_j itself is the dirty holder, no push.
    self_push = dirty_g * t_tran[:, None, None]   # (n, k, F)
    self_push = np.where(valid[None], self_push, 0.0)
    push_cost = push_any.sum(axis=1)[:, None] - self_push.sum(axis=2).T  # (k, n)
    return miss_cost + push_cost


def cost_matrix_np(
    samples: np.ndarray,
    latest_in_cache: np.ndarray,
    dirty: np.ndarray,
    t_tran: np.ndarray,
) -> np.ndarray:
    """Paper Alg. 1, vectorized numpy.

    Args:
      samples: (k, F) int ids, PAD_ID-padded; duplicate ids inside one
        sample count once per lookup (paper counts per-embedding ops, and a
        worker pulls a missing embedding once per iteration — we deduplicate
        per sample, matching the simulator's per-iteration set semantics).
      latest_in_cache: (n, V) bool — latest version of x is in w_j's cache.
      dirty: (n, V) bool — w_j holds an unsynced (trained-last-iter) copy.
      t_tran: (n,) per-embedding transmission time of each worker.

    Returns:
      (k, n) float64 cost matrix.
    """
    ids, valid = dedup_mask_np(samples)
    return _cost_from_gathers(latest_in_cache[:, ids], dirty[:, ids],
                              valid, t_tran)


def batch_unique_np(samples: np.ndarray):
    """(ids, mask, uids, inv): the batch's unique valid ids plus the
    compact index of every (sample, slot) into them.

    ``uids`` is sorted ascending; ``inv[i, f]`` indexes uids for valid
    slots and is clipped in-bounds (mask zero) elsewhere.
    """
    ids, mask = dedup_mask_np(samples)
    flat = ids[mask]
    uids = np.unique(flat) if flat.size else np.zeros(0, ids.dtype)
    if uids.size:
        inv = np.searchsorted(uids, ids)
        inv = np.minimum(inv, uids.size - 1)
    else:
        inv = np.zeros_like(ids)
    return ids, mask, uids, inv


def cost_from_state_cols(inv: np.ndarray, mask: np.ndarray,
                         lat_cols: np.ndarray, dirty_cols: np.ndarray,
                         t_tran: np.ndarray) -> np.ndarray:
    """(k, n) Alg. 1 from state gathered at the batch's unique ids only.

    inv/mask come from :func:`batch_unique_np`; lat_cols/dirty_cols are
    (n, U) — e.g. ``cache.state_columns(uids)``.  Expands the compact
    columns through ``inv`` and runs the exact dense arithmetic, so the
    result is bitwise-equal to :func:`cost_matrix_np` while never touching
    more than the U <= k*F ids in flight.
    """
    n = lat_cols.shape[0]
    if lat_cols.shape[1] == 0:
        return np.zeros((inv.shape[0], n), np.float64)
    return _cost_from_gathers(lat_cols[:, inv], dirty_cols[:, inv],
                              mask, t_tran)


def cost_matrix_sparse_np(
    samples: np.ndarray,
    latest_in_cache: np.ndarray,
    dirty: np.ndarray,
    t_tran: np.ndarray,
) -> np.ndarray:
    """Touched-ids Alg. 1 (numpy): gather state columns only for the
    batch's unique ids, then pool.  Same contract as — and bitwise equal
    to — :func:`cost_matrix_np`; O(k*F*n) with no O(V) term."""
    ids, mask, uids, inv = batch_unique_np(samples)
    return cost_from_state_cols(inv, mask, latest_in_cache[:, uids],
                                dirty[:, uids], t_tran)


def miss_time_from_state_cols(inv: np.ndarray, mask: np.ndarray,
                              lat_cols: np.ndarray,
                              t_cols: np.ndarray) -> np.ndarray:
    """(k, n) pull-ONLY Alg. 1 column: per-request wire time of the miss
    pulls alone, at a per-(worker, id) link time.

    inv/mask come from :func:`batch_unique_np`; lat_cols: (n, U) bool
    residency at the batch's unique ids; t_cols: (n, U) per-(worker, id)
    row transmission time.
    """
    n = lat_cols.shape[0]
    if lat_cols.shape[1] == 0:
        return np.zeros((inv.shape[0], n), np.float64)
    miss = (~lat_cols[:, inv]) & mask[None, :, :]          # (n, k, F)
    return (miss * t_cols[:, inv]).sum(axis=2).T           # (k, n)


# --------------------------------------------------------------------------
# multi-PS paths — per-(worker, shard) bandwidth, O(k*F*n) like the sparse
# --------------------------------------------------------------------------
def _cost_from_gathers_ps(latest_g: np.ndarray, dirty_g: np.ndarray,
                          valid: np.ndarray, t_ps: np.ndarray,
                          shard_g: np.ndarray) -> np.ndarray:
    """Alg. 1 arithmetic with per-shard link costs.

    latest_g/dirty_g: (n, k, F) gathered state; t_ps: (n, n_ps); shard_g:
    (k, F) owning shard per slot.  The miss term counts misses per shard
    (integer) before weighting, and the push term weights elementwise, so
    with n_ps == 1 every float op matches :func:`_cost_from_gathers`
    bitwise.
    """
    n_ps = t_ps.shape[1]
    onehot = (shard_g[..., None] == np.arange(n_ps)).astype(np.int64)  # (k,F,p)
    # miss pull: count per (worker, sample, shard), weight by the shard link
    miss = ((~latest_g) & valid[None, :, :]).astype(np.int64)     # (n, k, F)
    miss_ps = np.einsum("nkf,kfp->nkp", miss, onehot)
    miss_cost = (miss_ps * t_ps[:, None, :]).sum(axis=2).T        # (k, n)

    # update push: each dirty holder pushes over ITS link to the owning PS
    t_g = t_ps[:, shard_g]                                        # (n, k, F)
    push_any = (dirty_g * t_g).sum(axis=0)                        # (k, F)
    push_any = np.where(valid, push_any, 0.0)
    self_push = np.where(valid[None], dirty_g * t_g, 0.0)
    push_cost = push_any.sum(axis=1)[:, None] - self_push.sum(axis=2).T
    return miss_cost + push_cost


def cost_from_state_cols_ps(inv: np.ndarray, mask: np.ndarray,
                            lat_cols: np.ndarray, dirty_cols: np.ndarray,
                            t_ps: np.ndarray,
                            shard_cols: np.ndarray) -> np.ndarray:
    """(k, n) multi-PS Alg. 1 from state gathered at the batch's unique ids.

    Same contract as :func:`cost_from_state_cols` plus ``t_ps`` (n, n_ps)
    and ``shard_cols`` (U,) — the owning shard of each unique id (from
    ``PsPartition.shard_of`` / ``shard_of_linear``).
    """
    n = lat_cols.shape[0]
    if lat_cols.shape[1] == 0:
        return np.zeros((inv.shape[0], n), np.float64)
    return _cost_from_gathers_ps(lat_cols[:, inv], dirty_cols[:, inv],
                                 mask, t_ps, shard_cols[inv])


def cost_matrix_sparse_ps_np(
    samples: np.ndarray,
    latest_in_cache: np.ndarray,
    dirty: np.ndarray,
    t_ps: np.ndarray,
    part,
    linear: bool = False,
) -> np.ndarray:
    """Touched-ids multi-PS Alg. 1 (numpy).

    ``part`` is a :class:`repro_torch.ps.PsPartition`; ``linear=True`` means
    samples (and the state-plane columns) are already PS-linearized.  With
    ``part.n_ps == 1`` this is bitwise-equal to :func:`cost_matrix_sparse_np`
    at ``t_ps[:, 0]``.
    """
    ids, mask, uids, inv = batch_unique_np(samples)
    shard_u = (part.shard_of_linear(uids) if linear else part.shard_of(uids))
    return cost_from_state_cols_ps(inv, mask, latest_in_cache[:, uids],
                                   dirty[:, uids], t_ps, shard_u)


# --------------------------------------------------------------------------
# PyTorch: the decide stage's Alg. 1
# --------------------------------------------------------------------------
def dedup_mask(samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of :func:`dedup_mask_np`: (ids, mask) with PAD clamped
    to 0 and the first occurrence of each id in every sample kept.  The
    argsort is stable, as the reference's."""
    k, _ = samples.shape
    valid = samples != PAD_ID
    ids = torch.where(valid, samples, torch.zeros_like(samples))
    sort_idx = torch.argsort(samples, dim=1, stable=True)
    sorted_ids = torch.gather(samples, 1, sort_idx)
    first = torch.cat([torch.ones((k, 1), dtype=torch.bool,
                                  device=samples.device),
                       sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1)
    dedup = torch.zeros_like(first).scatter_(1, sort_idx, first)
    return ids, valid & dedup


def unique_padded(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Sorted unique values along the last dim, padded with ``fill`` to
    the same length: ``jnp.unique(x, size=x.shape[-1], fill_value=fill)``
    row by row, for a ``fill`` no smaller than any value.  Sort, mark the
    first of each run, scatter the firsts to their rank: no host sync."""
    s = torch.sort(x, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    L = x.shape[-1]
    rank = torch.cumsum(first, dim=-1) - 1
    out = torch.full(x.shape[:-1] + (L + 1,), fill, dtype=x.dtype,
                     device=x.device)
    out.scatter_(-1, torch.where(first, rank, L), s)   # repeats -> slot L
    return out[..., :L]


def per_id_cost_rows(latest_in_cache: torch.Tensor, dirty: torch.Tensor,
                     t_tran: torch.Tensor) -> torch.Tensor:
    """The (U, n) table v[x, j] of Alg.-1 cost contributions per id, over
    the (n, U) state columns given:

    v[x, j] = (1 - latest_in_cache[j, x]) * T_j  +  sum_{j'!=j} dirty[j', x] * T_{j'}

    The sum over workers is a left fold, j' = 0..n-1, as XLA reduces the
    reference's axis of n.
    """
    t = t_tran.to(torch.float32)
    miss = (1.0 - latest_in_cache.to(torch.float32)).T * t[None, :]
    pushes = dirty.to(torch.float32) * t[:, None]              # (n, U)
    push = _fold(pushes)[:, None] - dirty.to(torch.float32).T * t[None, :]
    return miss + push


def _fold(x: torch.Tensor) -> torch.Tensor:
    """The sum over the leading axis as a left fold, rows 0..n-1."""
    out = x[0]
    for j in range(1, x.shape[0]):
        out = out + x[j]
    return out


def cost_matrix_sparse(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                       dirty: torch.Tensor, t_tran: torch.Tensor
                       ) -> torch.Tensor:
    """Touched-ids Alg. 1 in plain PyTorch, the reference's
    ``cost_matrix_sparse_jnp``: gather the state at the batch's ids, one
    cost row per (sample, slot), masked and summed over the slots.
    (k, F) samples -> (k, n) f32."""
    k, F = samples.shape
    n = latest_in_cache.shape[0]
    ids, valid = dedup_mask(samples)
    flat = ids.reshape(-1).long()
    lat_g = latest_in_cache[:, flat]
    dirty_g = dirty[:, flat]
    rows = per_id_cost_rows(lat_g, dirty_g, t_tran).reshape(k, F, n)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.sum(dim=1)


def per_id_cost_rows_ps(latest_cols: torch.Tensor, dirty_cols: torch.Tensor,
                        t_cols: torch.Tensor) -> torch.Tensor:
    """Per-id cost rows with a per-(worker, id) link cost ``t_cols``
    (n, U), ``t_cols[j, x] = t_ps[j, shard_of(x)]``:

    v[x, j] = (1 - latest[j, x]) * t_cols[j, x]
              + sum_{j' != j} dirty[j', x] * t_cols[j', x]

    With column-constant ``t_cols`` this does the float ops of
    :func:`per_id_cost_rows`, in its order.  (n, U) columns -> (U, n)."""
    t = t_cols.to(torch.float32)
    miss = (1.0 - latest_cols.to(torch.float32)).T * t.T
    pushes = dirty_cols.to(torch.float32) * t                   # (n, U)
    push = _fold(pushes)[:, None] - dirty_cols.to(torch.float32).T * t.T
    return miss + push


def cost_matrix_sparse_ps(samples: torch.Tensor,
                          latest_in_cache: torch.Tensor,
                          dirty: torch.Tensor, t_ps: torch.Tensor, part,
                          linear: bool = False) -> torch.Tensor:
    """Touched-ids multi-PS Alg. 1 in plain PyTorch, the reference's
    ``cost_matrix_sparse_ps_jnp``: a miss or a push on an id costs the
    link to its owning shard.  ``part`` is a
    :class:`repro_torch.ps.PsPartition`; ``linear=True`` means samples
    and planes are already PS-linearized.  (k, F) samples, (n, V)
    planes, (n, n_ps) link times -> (k, n) f32."""
    k, F = samples.shape
    n = latest_in_cache.shape[0]
    ids, valid = dedup_mask(samples)
    shard = part.shard_of_linear(ids) if linear else part.shard_of(ids)
    flat = ids.reshape(-1).long()
    t_cols = t_ps.to(torch.float32)[:, shard.reshape(-1).long()]  # (n, k*F)
    rows = per_id_cost_rows_ps(latest_in_cache[:, flat], dirty[:, flat],
                               t_cols).reshape(k, F, n)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.sum(dim=1)


def cost_matrix_dense(samples: torch.Tensor, latest_in_cache: torch.Tensor,
                      dirty: torch.Tensor, t_tran: torch.Tensor
                      ) -> torch.Tensor:
    """Alg. 1 over the dense (V, n) per-id table in plain PyTorch, the
    reference's ``cost_matrix_jnp``: every id's cost row, then the
    sample's rows gathered, masked and summed.  (k, F) samples -> (k, n)
    f32."""
    ids, valid = dedup_mask(samples)
    v = per_id_cost_rows(latest_in_cache, dirty, t_tran)         # (V, n)
    rows = v[ids.long()]                                          # (k, F, n)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.sum(dim=1)
