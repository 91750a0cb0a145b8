"""The yardstick: the card's published peaks, the paper's link times,
the model's operations a sample and the bytes a kernel call needs.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W
(dense rates): a share is stated against them, with the card's power
limit printed beside it.
"""
from __future__ import annotations

import numpy as np

from .reference.codec import row_bytes
from .reference.models import kind_of

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "GBPS", "link_times",
           "model_flops_per_sample", "alg1_cost_bytes", "kept_slots",
           "pack_send_all_bytes", "merged", "union"]

HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
GBPS = 1e9 / 8                 # bytes a second in one Gbps


def link_times(embedding_dim: int, bandwidths_gbps, codec=None
               ) -> np.ndarray:
    """Each link's time for one embedding row, in seconds: the paper's
    T_j = D_tran / B_j (Table 1), D_tran the row's bytes on the wire (4 E
    in f32; a codec's codes and metadata on every link)."""
    bw = np.asarray(bandwidths_gbps, np.float64) * GBPS
    return np.asarray(float(row_bytes(embedding_dim, codec)),
                      np.float64) / bw


def model_flops_per_sample(cfg: dict) -> float:
    """Forward and backward operations of one sample: the kind's forward
    operations (``reference/models/<kind>.py::flops_per_sample``: every
    product, elementwise term and pooling sum) three times (the forward,
    the input's and the weight's gradient).  The embedding gather and
    the optimizer are counted as bytes, not operations."""
    return 3.0 * kind_of(cfg).flops_per_sample(cfg)


def alg1_cost_bytes(n: int, m: int, width: int, kept: int) -> int:
    """``alg1_cost`` as decide calls it: the (n m, width) int32 ids
    read, the ``latest`` and ``dirty`` bytes of all n workers (2n) for
    each of the ``kept`` slots (not PAD, the first of its id in its
    sample), the (n, m, n) f32 costs written."""
    return 4 * n * m * width + 2 * n * kept + 4 * n * m * n


def kept_slots(sparse: np.ndarray) -> int:
    """The slots of a (samples, width) id batch that Alg. 1 prices: not
    PAD (-1) and the first of its id in its sample."""
    s = np.sort(sparse, axis=1)
    kept = s != -1
    kept[:, 1:] &= s[:, 1:] != s[:, :-1]
    return int(kept.sum())


def pack_send_all_bytes(n: int, m: int, row_words: int) -> int:
    """B2 on the step: the (n, m) int32 assignment and every payload
    row (``row_words`` 4-byte words a sample: ids, dense, label) read
    once, the same rows written into the send blocks, the (n, n) counts
    and the overflow word written."""
    return 4 * n * m + 2 * 4 * n * m * row_words + 4 * n * n + 4


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union(intervals) -> float:
    return float(sum(e - s for s, e in merged(intervals)))
