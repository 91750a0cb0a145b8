"""The yardstick: the card's published peaks, the paper's link times,
the model's operations a sample and the bytes a kernel call needs.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W
(dense rates): a share is stated against them, with the card's power
limit printed beside it.
"""
from __future__ import annotations

import numpy as np

from .reference.codec import row_bytes

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "GBPS", "link_times",
           "model_flops_per_sample", "pooled_lookup_bytes",
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


def _mlp_flops(din: int, dims) -> int:
    total = 0
    for dout in dims:
        total += 2 * din * dout
        din = dout
    return total


def model_flops_per_sample(cfg: dict) -> float:
    """Forward and backward operations of one sample: every product
    (bottom and top MLP, the cross layers' x @ w) three times its
    forward (the forward, the input's and the weight's gradient), the
    cross layers' elementwise terms and the interaction's pooling sums
    likewise.  The embedding gather and the optimizer are counted as
    bytes, not operations."""
    E, F = cfg["embedding_dim"], len(cfg["table_sizes"])
    W = F + cfg["hist_max"]
    dims = list(cfg["mlp_dims"])
    fwd = _mlp_flops(cfg["n_dense"], dims + [E])
    if cfg["kind"] == "dcn":
        d = E * (F + 2)
        fwd += _mlp_flops(d, dims + [1])
        # x @ w (2d), x0 * xw, + b, + x (3d) a layer; pooling the bag
        fwd += cfg["cross_layers"] * 5 * d + cfg["hist_max"] * E
    else:
        fwd += _mlp_flops(E, dims + [1])
        # the bag's mean over W rows, the dense projection added, wide
        fwd += W * E + E + W
    return 3.0 * fwd


def pooled_lookup_bytes(bags: int, width: int, unique_rows: int,
                        cols: int) -> int:
    """B1 as decide calls it: (bags, width) int32 ids and f32 weights
    read, ``unique_rows`` rows of the (U, cols) f32 cost table read
    once, the (bags, cols) f32 result written."""
    return 8 * bags * width + 4 * unique_rows * cols + 4 * bags * cols


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
