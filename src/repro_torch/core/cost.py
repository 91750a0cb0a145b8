"""Alg. 1 — the numpy subset of the expected-cost module that the
serving path needs: per-link row transmission time and the pull-only
cost column over a batch's unique ids.  Copied from the JAX package's
``core/cost.py``, bit for bit, so both packages price requests alike.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PAD_ID", "transmission_time", "transmission_time_codec",
           "dedup_mask_np", "batch_unique_np", "miss_time_from_state_cols"]

PAD_ID = -1  # padding slot inside a sample's id list


def transmission_time(d_tran_bytes: float, bandwidth_bytes_per_s: np.ndarray) -> np.ndarray:
    """T_j = D_tran / B_j (paper Table 1)."""
    return np.asarray(d_tran_bytes, np.float64) / np.asarray(bandwidth_bytes_per_s, np.float64)


def transmission_time_codec(n_elems: int, bandwidth_bytes_per_s: np.ndarray,
                            link_codecs=None) -> np.ndarray:
    """Per-link row transmission time for an ``n_elems``-wide fp32
    embedding row.  Quantized wire codecs (``link_codecs``) come with the
    quantized-wire slice of the port."""
    if link_codecs is not None:
        raise NotImplementedError(
            "per-link wire codecs arrive with the quantized-wire slice")
    bw = np.asarray(bandwidth_bytes_per_s, np.float64)
    return transmission_time(n_elems * 4.0, bw)


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
