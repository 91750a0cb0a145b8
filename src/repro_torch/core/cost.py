"""Alg. 1 — the expected-cost module.

Numpy (copied from the JAX package's ``core/cost.py``, bit for bit, so
both packages price serving requests alike): per-link row transmission
time, fp32 or under per-link wire codecs, and the pull-only cost column
over a batch's unique ids.

PyTorch (the training step's decide stage): the per-sample id dedup, the
per-id cost rows and the plain touched-ids Alg. 1, counterparts of the
reference's ``dedup_mask_jnp``, ``per_id_cost_rows`` and
``cost_matrix_sparse_jnp``.  The decide stage itself prices through the
pooled-lookup kernel (:func:`repro_torch.kernels.ops.
cost_matrix_sparse_kernel`); :func:`cost_matrix_sparse` is the
reference's second formula, kept for comparison.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PAD_ID", "transmission_time", "transmission_time_codec",
           "dedup_mask_np", "batch_unique_np", "miss_time_from_state_cols",
           "dedup_mask", "unique_padded", "per_id_cost_rows",
           "cost_matrix_sparse"]

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
    push_tot = pushes[0]
    for j in range(1, pushes.shape[0]):
        push_tot = push_tot + pushes[j]
    push = push_tot[:, None] - dirty.to(torch.float32).T * t[None, :]
    return miss + push


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
