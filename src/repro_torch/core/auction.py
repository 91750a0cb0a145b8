"""The auction in PyTorch: the eps-scaled solver (the paper's parallel
``Opt``) and the batched round of the training step's decide stage.

A port of the JAX package's ``core/auction.py``: every unassigned sample
(bidder) bids for its best-value worker against that worker's cheapest
slot; each worker matches its bidders, by bid descending, against its
slots, by price ascending, and accepts every prefix pair with bid >
price.  Worker capacities use the "similar objects" form: each worker
owns ``capacity`` slots with prices of their own.

* :func:`auction_solve` / :func:`auction_dispatch` — one auction, its
  bids in the bid kernel (:func:`repro_torch.kernels.auction.
  auction_bids`, CUDA on the card) and its slot matching
  (:func:`_resolve`) in PyTorch; the rounds loop on the host.  This is
  the simulator's and the serving simulator's ``opt="auction"``.
* :func:`_round_body` and :func:`_repair` take a leading batch
  dimension ``B`` (one independent auction per worker of the training
  step, :func:`repro_torch.core.dispatch.auction_fixed`), so one launch
  serves every worker: cost ``(B, k, n)``, eps ``(B,)``, and the state
  ``(assign (B, k) int32, slot_prices (B, n, c) f32, slot_owner (B, n,
  c) int32)``.  Their bids are the bid kernel's plain version.

Every argsort is stable, as the reference's; a scatter the reference
drops out of range lands in a scratch slot past the end here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.auction import NEG, auction_bids, auction_bids_ref, replay

__all__ = ["NEG", "_round_body", "_resolve", "_repair", "auction_solve",
           "auction_dispatch"]


def _drop_scatter(t: torch.Tensor, idx: torch.Tensor,
                  src) -> torch.Tensor:
    """``t.at[b, idx].set(src, mode="drop")`` along dim 1 for indices
    in [0, t.shape[1]]: index ``t.shape[1]`` writes a scratch column."""
    B, k = t.shape
    ext = torch.cat([t, t.new_zeros((B, 1))], dim=1)
    return ext.scatter_(1, idx, src)[:, :k]


def _resolve(state, best_j: torch.Tensor, bid: torch.Tensor):
    """The slot matching of one round, given the bids (reference
    ``kernels/ops.py:_resolve``): each worker matches its bidders, by bid
    descending, against its slots, by price ascending, and accepts every
    prefix pair with bid > price; displaced owners become unassigned and
    each winner pays its own bid.  best_j, bid: (B, k); a bid of NEG
    (an assigned row) never matches."""
    assign, slot_prices, slot_owner = state
    B, n, c = slot_prices.shape
    k = assign.shape[1]
    L = min(k, c)

    # (B, n, k) bids per worker, NEG where not a bidder for it
    workers = torch.arange(n, device=bid.device)
    bid_mat = torch.where(best_j[:, None, :] == workers[None, :, None],
                          bid[:, None, :], torch.full_like(bid[:, None, :],
                                                           NEG))
    bid_order = torch.argsort(-bid_mat, dim=2, stable=True)[:, :, :L]
    top_bids = torch.gather(bid_mat, 2, bid_order)                 # desc
    price_order = torch.argsort(slot_prices, dim=2, stable=True)[:, :, :L]
    low_prices = torch.gather(slot_prices, 2, price_order)

    match = (top_bids > low_prices) & (top_bids > NEG / 2)
    prev_owner = torch.gather(slot_owner, 2, price_order)          # (B, n, L)
    rows = workers[None, :, None].expand(B, n, L).to(torch.int32)

    # displaced owners become unassigned, then winners take their slots
    disp = torch.where(match & (prev_owner >= 0), prev_owner.long(), k)
    assign = _drop_scatter(assign, disp.reshape(B, -1), -1)
    winners = torch.where(match, bid_order, k)
    assign = _drop_scatter(assign, winners.reshape(B, -1),
                           rows.reshape(B, -1))
    slot_prices = slot_prices.scatter(
        2, price_order, torch.where(match, top_bids, low_prices))
    slot_owner = slot_owner.scatter(
        2, price_order, torch.where(match, bid_order.to(torch.int32),
                                    prev_owner))
    return assign, slot_prices, slot_owner


def _round_body(cost: torch.Tensor, eps: torch.Tensor, state):
    """One batched Jacobi auction round (reference ``_round_body``): the
    bids of every unassigned row in plain PyTorch, then the slot
    matching.  eps: (B,)."""
    assign, slot_prices, _ = state
    best_j, bid = auction_bids_ref(cost, slot_prices.amin(dim=2),
                                   assign < 0, eps[:, None])
    return _resolve(state, best_j, bid)


def _repair(cost: torch.Tensor, eps: torch.Tensor, state):
    """eps-CS repair (reference ``_repair``): reprice ownerless slots to
    zero, then unassign every owner whose net value at its slot falls
    more than eps below its best alternative."""
    assign, slot_prices, slot_owner = state
    B, k, n = cost.shape
    c = slot_prices.shape[2]
    benefit = -cost
    slot_prices = torch.where(slot_owner < 0,
                              torch.zeros_like(slot_prices), slot_prices)
    min_price = slot_prices.amin(dim=2)                           # (B, n)
    best_alt = (benefit - min_price[:, None, :]).amax(dim=2)      # (B, k)

    owner_flat = slot_owner.reshape(B, n * c)
    price_flat = slot_prices.reshape(B, n * c)
    worker_of_slot = torch.arange(n, device=cost.device).repeat_interleave(c)
    safe_owner = torch.where(owner_flat >= 0, owner_flat,
                             torch.zeros_like(owner_flat)).long()
    net_flat = torch.gather(benefit.reshape(B, k * n), 1,
                            safe_owner * n + worker_of_slot[None, :]) \
        - price_flat
    violate_flat = (owner_flat >= 0) & (
        net_flat < torch.gather(best_alt, 1, safe_owner) - eps[:, None])

    assign = _drop_scatter(assign,
                           torch.where(violate_flat, owner_flat.long(), k), -1)
    violate = violate_flat.reshape(B, n, c)
    slot_owner = torch.where(violate, torch.full_like(slot_owner, -1),
                             slot_owner)
    slot_prices = torch.where(violate, torch.zeros_like(slot_prices),
                              slot_prices)
    return assign, slot_prices, slot_owner


# --------------------------------------------------------------------------
# the eps-scaled solver on the bid kernel (the paper's parallel Opt)
# --------------------------------------------------------------------------
def _bid_round(cost: torch.Tensor, eps: torch.Tensor, state):
    """One round on the bid kernel: the bids of every unassigned row, then
    the slot matching.  cost: (k, n); eps: (1,); state with a leading
    batch of 1."""
    best_j, bid = auction_bids(cost, state[1][0].amin(dim=1),
                               state[0][0] < 0, eps)
    return _resolve(state, best_j[None], bid[None])


def _write(state, new):
    for t, v in zip(state, new):
        t.copy_(v)


def _solve(cost: torch.Tensor, capacity: int, eps: float, max_rounds: int,
           scaling: float, n_final: int):
    """The eps-scaled auction with ``n_final`` phases at the final eps.

    The phase list is built as the reference builds it: Python floats
    from the f32 span, each eps rounded to f32 once.  Each phase runs
    rounds until every row is assigned, at most ``max_rounds`` (the
    reference's ``_auction_phase``), testing for an unassigned row before
    every round, as the reference's ``while_loop`` does: so the bid
    kernel launches once per round the reference counts, and never on a
    round that would change nothing.

    The state lives in fixed tensors updated in place.  On the card a
    round is about 40 small kernels, which cost 0.5–1.2 ms to launch one
    by one from Python against about 0.12 ms as a replayed CUDA graph; so
    the first round runs eagerly (it also warms up what the round's
    kernels need) and every later round replays a graph of it.  eps lives in a device tensor that the bid kernel reads,
    so one graph serves every phase.
    """
    k, n = cost.shape
    span = float(cost.max() - cost.min())
    phases = []
    e = max(span / 2.0, eps)
    while e > eps:
        phases.append(e)
        e /= scaling
    phases.extend([eps] * n_final)
    dev = cost.device
    state = (torch.full((1, k), -1, dtype=torch.int32, device=dev),
             torch.zeros((1, n, capacity), dtype=torch.float32, device=dev),
             torch.full((1, n, capacity), -1, dtype=torch.int32, device=dev))
    eps_t = torch.zeros((1,), dtype=torch.float32, device=dev)
    graph = None
    total = 0
    for i, e in enumerate(phases):
        eps_t.fill_(float(np.float32(e)))
        if i:
            _write(state, _repair(cost[None], eps_t, state))
        rounds = 0
        while rounds < max_rounds and bool((state[0] < 0).any()):
            if graph is not None:
                replay(graph)
            else:
                _write(state, _bid_round(cost, eps_t, state))
                if cost.is_cuda:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        _write(state, _bid_round(cost, eps_t, state))
            rounds += 1
        total += rounds
    return state[0][0], total


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
