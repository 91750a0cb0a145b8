"""HybridDis (Alg. 2) — hybrid Opt/Heu dispatch decision.

Rows of the cost matrix are sorted by ``min2 - min`` (the regret of a wrong
greedy choice) in descending order; the top ``alpha`` fraction is solved by
the optimal assignment solver (``Opt``: the Hungarian oracle, SSP, or
the eps-scaled auction whose bids run in the bid kernel on ``device``),
the remainder by the greedy ``Heu``.  Each worker's capacity m is split:
``floor(m * alpha)`` slots for Opt, the rest for Heu.

Feasibility note: Alg. 2 expands Opt's columns to ``floor(m*alpha)`` slots
per worker, which caps Opt rows at ``n*floor(m*alpha)``; when
``floor(k*alpha)`` exceeds that (integer-rounding corner) we clamp the Opt
row count, exactly preserving per-worker capacities.
"""
from __future__ import annotations

from typing import Callable, Literal

import numpy as np

from .auction import auction_dispatch
from .heu import heu_dispatch, min2_minus_min
from .hungarian import hungarian_dispatch
from .ssp import ssp_dispatch

__all__ = ["hybrid_dispatch"]

OptName = Literal["hungarian", "auction", "ssp"]


def _opt_solver(name: OptName, device="cuda"
                ) -> Callable[[np.ndarray, int], np.ndarray]:
    if name == "hungarian":
        return hungarian_dispatch
    if name == "auction":
        return lambda c, cap: auction_dispatch(c, cap, exact=True,
                                               device=device)
    if name == "ssp":
        return ssp_dispatch
    raise ValueError(name)


def hybrid_dispatch(
    cost: np.ndarray,
    maxworkload: int,
    alpha: float,
    opt: OptName = "hungarian",
    variant: str = "paper",
    device="cuda",
) -> np.ndarray:
    """Alg. 2.  Returns (k,) worker of each sample (original row order).

    ``variant="paper"`` reserves exactly ``floor(m*alpha)`` slots per worker
    for the Opt rows (Alg. 2 line 6).  ``variant="opt_first"`` lets Opt
    solve the same alpha-fraction of rows against FULL per-worker capacity
    and Heu fill the remaining slots.  ``device`` is where the auction
    runs (``opt="auction"`` only; the other solvers are numpy).
    """
    cost = np.asarray(cost, np.float64)
    k, n = cost.shape
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0,1], got {alpha}")
    if k > maxworkload * n:
        raise ValueError("infeasible: k > maxworkload * n")

    out = np.full(k, -1, dtype=np.int64)

    if alpha == 0.0:
        order = np.argsort(-min2_minus_min(cost), kind="stable")
        return heu_dispatch(cost, maxworkload, order=order)

    if variant == "opt_first":
        opt_cap = maxworkload
        opt_rows = int(np.floor(k * alpha))
    else:
        opt_cap = int(np.floor(maxworkload * alpha)) if alpha < 1.0 else maxworkload
        opt_rows = min(int(np.floor(k * alpha)), opt_cap * n)

    order = np.argsort(-min2_minus_min(cost), kind="stable")
    opt_idx, heu_idx = order[:opt_rows], order[opt_rows:]

    workload = np.zeros(n, dtype=np.int64)
    if opt_rows:
        assign_opt = _opt_solver(opt, device)(cost[opt_idx], opt_cap)
        out[opt_idx] = assign_opt
        workload += np.bincount(assign_opt, minlength=n)

    if len(heu_idx):
        # Heu fills the remaining capacity; rows processed in min2-min order
        sub = heu_dispatch(
            cost[heu_idx], maxworkload, workload=workload
        )
        out[heu_idx] = sub
    return out
