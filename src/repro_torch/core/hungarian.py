"""Serial Hungarian solver (the paper's ``Opt`` oracle / Table 2 "Serial" row).

O(k^3) shortest-augmenting-path Kuhn–Munkres with potentials, numpy-
vectorized inner relaxation.  This is the exact-optimal reference that the
paper runs on CPU (Table 2) and that their CUDA kernel parallelizes; here it
is one of Alg. 2's ``Opt`` solvers and the oracle the others are held to.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hungarian", "expand_capacity", "hungarian_dispatch"]


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of rows to distinct columns.

    Args:
      cost: (R, C) float matrix, R <= C.

    Returns:
      col_of_row: (R,) int array; ``col_of_row[i]`` is the column assigned
      to row i.  Total cost ``cost[np.arange(R), col_of_row].sum()`` is
      minimal over all injections rows->columns.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n > m:
        raise ValueError(f"need rows<=cols, got {cost.shape}")
    INF = np.inf
    # 1-indexed potentials / matching, column 0 is a virtual column.
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)  # p[j] = row matched to column j
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # relax all unused columns against row i0 (vectorized)
            free = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:][better] = j0
            # pick the free column with minimal reduced distance
            masked = np.where(free, minv[1:], INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            # update potentials
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        # augment along the alternating path
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.zeros(n, dtype=np.int64)
    for j in range(1, m + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    return col_of_row


def expand_capacity(cost: np.ndarray, capacity: int) -> np.ndarray:
    """Tile each worker column ``capacity`` times (paper Sec. 4.3).

    The (m*n, n) ESD cost matrix becomes a square (m*n, m*n) assignment
    instance where worker j owns columns [j*capacity, (j+1)*capacity).
    """
    k, n = cost.shape
    if k > capacity * n:
        raise ValueError(f"rows {k} > capacity {capacity} * workers {n}")
    return np.repeat(cost, capacity, axis=1)


def hungarian_dispatch(cost: np.ndarray, capacity: int) -> np.ndarray:
    """Optimal dispatch of samples to workers with per-worker capacity.

    Args:
      cost: (k, n) expected transmission costs (k = capacity * n).
    Returns:
      worker_of_sample: (k,) ints in [0, n).
    """
    n = cost.shape[1]
    expanded = expand_capacity(np.asarray(cost, np.float64), capacity)
    cols = hungarian(expanded)
    return (cols // capacity).astype(np.int64)
