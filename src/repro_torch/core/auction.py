"""The auction's round and repair in PyTorch (the in-step ``Opt``).

A port of the round body and the eps-CS repair of the JAX package's
``core/auction.py``: every unassigned sample (bidder) bids for its
best-value worker against that worker's cheapest slot; each worker
matches its bidders, by bid descending, against its slots, by price
ascending, and accepts every prefix pair with bid > price.  Worker
capacities use the "similar objects" form: each worker owns
``capacity`` slots with prices of their own.

Both functions take a leading batch dimension ``B`` (one independent
auction per worker of the training step), so one launch serves every
worker: cost ``(B, k, n)``, eps ``(B,)``, and the state ``(assign (B,
k) int32, slot_prices (B, n, c) f32, slot_owner (B, n, c) int32)``.
Every argsort is stable, as the reference's; a scatter the reference
drops out of range lands in a scratch slot past the end here.
"""
from __future__ import annotations

import torch

__all__ = ["NEG", "_round_body", "_repair"]

NEG = -1e30


def _drop_scatter(t: torch.Tensor, idx: torch.Tensor,
                  src) -> torch.Tensor:
    """``t.at[b, idx].set(src, mode="drop")`` along dim 1 for indices
    in [0, t.shape[1]]: index ``t.shape[1]`` writes a scratch column."""
    B, k = t.shape
    ext = torch.cat([t, t.new_zeros((B, 1))], dim=1)
    return ext.scatter_(1, idx, src)[:, :k]


def _round_body(cost: torch.Tensor, eps: torch.Tensor, state):
    """One batched Jacobi auction round (reference ``_round_body``)."""
    assign, slot_prices, slot_owner = state
    B, k, n = cost.shape
    c = slot_prices.shape[2]
    L = min(k, c)
    benefit = -cost

    min_price = slot_prices.amin(dim=2)                           # (B, n)
    unassigned = assign < 0                                       # (B, k)
    values = benefit - min_price[:, None, :]                      # (B, k, n)
    best_j = values.argmax(dim=2)                                 # first max
    w1 = values.amax(dim=2)
    v2 = values.scatter(2, best_j[:, :, None], NEG)
    w2 = v2.amax(dim=2)
    if n == 1:
        w2 = w1
    bid = torch.gather(min_price, 1, best_j) + (w1 - w2) + eps[:, None]

    # (B, n, k) bids per worker, NEG where not an unassigned bidder for it
    workers = torch.arange(n, device=cost.device)
    bid_mat = torch.where(
        unassigned[:, None, :] & (best_j[:, None, :] == workers[None, :, None]),
        bid[:, None, :], torch.full_like(bid[:, None, :], NEG))
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
