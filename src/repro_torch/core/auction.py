"""The auction in PyTorch: the eps-scaled solver (the paper's parallel
``Opt``) on the fused auction kernel.

A port of the JAX package's ``core/auction.py``: every unassigned sample
(bidder) bids for its best-value worker against that worker's cheapest
slot; each worker matches its bidders, by bid descending, against its
slots, by price ascending, and accepts every prefix pair with bid >
price.  Worker capacities use the "similar objects" form: each worker
owns ``capacity`` slots with prices of their own.

:func:`auction_solve` / :func:`auction_dispatch` build the phase list on
the host and solve in one launch of :func:`repro_torch.kernels.auction.
auction_solve` (CUDA on the card, its plain version on the CPU): every
phase and round runs on the device, and the host reads the rounds once
per solve.  This is the simulator's and the serving simulator's
``opt="auction"``; the training step's in-step auction
(:func:`repro_torch.core.dispatch.auction_fixed`) runs on the same
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import auction as KA
from ..kernels.auction import NEG

__all__ = ["NEG", "auction_solve", "auction_dispatch", "phase_eps"]


def phase_eps(span: float, eps: float, scaling: float = 6.0,
              n_final: int = 3) -> list:
    """The eps of each phase, as the reference builds them: span / 2,
    divided by ``scaling`` while above ``eps``, then ``n_final`` phases
    at ``eps``; Python floats, each to be rounded to f32 once."""
    phases = []
    e = max(span / 2.0, eps)
    while e > eps:
        phases.append(e)
        e /= scaling
    return phases + [eps] * n_final


def _solve(cost: torch.Tensor, capacity: int, eps: float, max_rounds: int,
           scaling: float, n_final: int):
    """The eps-scaled auction with ``n_final`` phases at the final eps,
    from the f32 span of ``cost``.  Each phase runs rounds until every
    row is assigned, at most ``max_rounds`` (the reference's
    ``_auction_phase``), testing for an unassigned row before every
    round, as the reference's ``while_loop`` does.
    """
    phases = phase_eps(float(cost.max() - cost.min()), eps, scaling,
                       n_final)
    eps_t = torch.tensor([[float(np.float32(e)) for e in phases]],
                         dtype=torch.float32, device=cost.device)
    assign, _, _, rounds = KA.auction_solve(cost[None].contiguous(),
                                            capacity, eps_t, max_rounds)
    return assign[0], int(rounds.sum())


def auction_solve(cost: torch.Tensor, capacity: int, eps: float = 1e-3,
                  max_rounds: int = 500_000, scaling: float = 6.0):
    """eps-scaled auction (reference ``auction_solve``).  cost: (k, n)
    f32 on the device to solve on, k <= capacity * n.

    Phase 1 solves from scratch at a coarse eps (span / 2); every later
    phase shrinks eps by ``scaling`` and re-bids only the rows that repair
    unassigned; three terminal phases at the final eps rerun repair and
    re-bid, as the reference does.  Returns (assign (k,) int32, -1 where
    ``max_rounds`` ran out, and the rounds in all phases)."""
    return _solve(cost, capacity, eps, max_rounds, scaling, n_final=3)


def auction_dispatch(cost: np.ndarray, capacity: int, *, exact: bool = True,
                     eps_frac: float = 1e-3, max_rounds: int = 200_000,
                     device="cuda", return_rounds: bool = False):
    """Dispatch rows of ``cost`` (k, n) to workers with capacity, via the
    auction on ``device`` (reference ``auction_dispatch``).

    With ``exact=True`` costs are scaled to an integer grid and eps is
    1 / (k + 1), so the assignment is optimal on the grid; otherwise the
    f32 costs are solved at eps = span * eps_frac.  Rows still unassigned
    when ``max_rounds`` runs out in a phase are filled greedily into free
    capacity, as the reference does.  Returns (k,) int64, and the
    solver's rounds too with ``return_rounds``."""
    dev = resolve_device(device)
    cost = np.asarray(cost, np.float64)
    k, n = cost.shape
    span = float(cost.max() - cost.min())
    if span == 0.0:
        out = np.repeat(np.arange(n), capacity)[:k].astype(np.int64)
        return (out, 0) if return_rounds else out
    if exact:
        if np.allclose(cost, np.round(cost)):
            scaled = np.round(cost - cost.min())   # already integral: exact
        else:
            # scale to an integer grid; exact on the rounded instance and
            # within k/2 grid units of the true optimum
            scaled = np.round((cost - cost.min()) / span * 10_000.0)
        eps = 1.0 / (k + 1)
        work = scaled.astype(np.float32)
    else:
        # near-optimal: total gap bounded by k * eps_frac * span
        work = cost.astype(np.float32)
        eps = span * eps_frac
    assign, rounds = auction_solve(torch.from_numpy(work).to(dev), capacity,
                                   eps=eps, max_rounds=max_rounds)
    assign = assign.cpu().numpy().astype(np.int64)
    if (assign < 0).any():
        # max_rounds ran out: greedy-fill leftover rows into free capacity
        free = capacity - np.bincount(assign[assign >= 0], minlength=n)
        for i in np.where(assign < 0)[0]:
            j = int(np.argmax(free))
            assign[i] = j
            free[j] -= 1
    return (assign, rounds) if return_rounds else assign
