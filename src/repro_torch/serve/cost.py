"""Latency-SLO dispatch cost for the serving path (host side, numpy).

The cost of placing request i on worker j is the estimated completion
latency plus a hinge penalty past the request's remaining SLO slack:

    est_lat[i, j] = queue_s[j] + service_s[j] + pull[i, j]
    C[i, j]       = est_lat[i, j]
                    + slo_penalty * max(0, est_lat[i, j] - slack_s[i])

``pull[i, j]`` is Alg. 1's read-only column (miss pulls only) at the
per-worker link time.  Assignment is the paper's Alg. 2 on this matrix.
"""
from __future__ import annotations

import numpy as np

from ..core.cost import batch_unique_np, miss_time_from_state_cols
from ..core.hybrid import hybrid_dispatch

__all__ = ["serve_cost_matrix", "serve_decide"]


def serve_cost_matrix(samples: np.ndarray, resident: np.ndarray,
                      t_row: np.ndarray, queue_s: np.ndarray,
                      service_s: np.ndarray, slack_s: np.ndarray,
                      *, slo_penalty: float = 4.0) -> np.ndarray:
    """(B, n) latency-SLO cost matrix (module docstring equation).

    samples: (B, W) flat ids, PAD = -1; resident: (n, V) bool read-only
    plane residency; t_row: (n,) per-embedding-row link time;
    queue_s/service_s: (n,) seconds; slack_s: (B,) seconds until each
    request's deadline (``inf`` disables the hinge for that row).
    Multi-PS link times come with the multi-PS slice of the port.
    """
    samples = np.asarray(samples)
    t_row = np.asarray(t_row, np.float64)
    if t_row.ndim != 1:
        raise NotImplementedError(
            "per-(worker, PS) link times arrive with the multi-PS slice")
    queue_s = np.asarray(queue_s, np.float64)
    service_s = np.asarray(service_s, np.float64)
    slack_s = np.asarray(slack_s, np.float64)
    n = resident.shape[0]
    _, mask, uids, inv = batch_unique_np(samples)
    lat_cols = np.asarray(resident)[:, uids] if uids.size else \
        np.zeros((n, 0), bool)
    t_cols = np.broadcast_to(t_row[:, None], (n, max(uids.size, 1)))
    if uids.size == 0:
        pull = np.zeros((samples.shape[0], n), np.float64)
    else:
        pull = miss_time_from_state_cols(inv, mask, lat_cols, t_cols)
    est_lat = queue_s[None, :] + service_s[None, :] + pull
    over = np.maximum(est_lat - slack_s[:, None], 0.0)
    over = np.where(np.isfinite(slack_s)[:, None], over, 0.0)
    return est_lat + slo_penalty * over


def serve_decide(C: np.ndarray, *, cap: int, alpha: float = 1.0,
                 opt: str = "ssp") -> np.ndarray:
    """(B,) worker per request: Alg. 2 on the latency-SLO matrix.

    ``cap`` bounds requests per worker within one micro-batch; ``alpha``
    splits Opt/Heu exactly as in training dispatch.
    """
    return hybrid_dispatch(C, cap, alpha, opt=opt)
