"""Heu — the resource-efficient greedy dispatcher (Alg. 2 lines 9-18).

Greedily dispatch each sample (row of the cost matrix) to its cheapest
worker whose workload is below ``maxworkload``; on conflict fall through to
the next-cheapest column.  Theorem 1: the worst-case per-row error after
processing row i is ``min_{floor(i/m)+1} - min``.

Also provides :func:`min2_minus_min`, the HybridDis partition criterion.
"""
from __future__ import annotations

import numpy as np

__all__ = ["heu_dispatch", "min2_minus_min"]


def min2_minus_min(cost: np.ndarray) -> np.ndarray:
    """Per-row (second-minimum - minimum) — the greedy-regret proxy."""
    part = np.partition(cost, 1, axis=1)
    return part[:, 1] - part[:, 0]


def heu_dispatch(
    cost: np.ndarray,
    maxworkload: int,
    workload: np.ndarray | None = None,
    order: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy min-cost dispatch with per-worker capacity.

    Args:
      cost: (k, n) cost matrix.
      maxworkload: capacity per worker for THIS call.
      workload: optional (n,) pre-existing workload counts (mutated).
      order: optional row processing order (defaults to natural order, which
        is what Alg. 2 uses after its min2-min sort has been applied by the
        caller).

    Returns:
      (k,) worker index per row (in the original row numbering).
    """
    cost = np.asarray(cost)
    k, n = cost.shape
    if workload is None:
        workload = np.zeros(n, dtype=np.int64)
    if order is None:
        order = np.arange(k)
    # per-row ranked worker preference, cheap since n is small
    pref = np.argsort(cost, axis=1, kind="stable")
    out = np.full(k, -1, dtype=np.int64)
    for i in order:
        for j in pref[i]:
            if workload[j] < maxworkload:
                out[i] = j
                workload[j] += 1
                break
        else:  # pragma: no cover - capacities always sum to >= k
            raise RuntimeError("no worker with spare capacity")
    return out
