"""The auction's kernels: wrappers and plain versions.

:func:`auction_solve` — a whole eps-scaled auction in one launch.  For
each of B auctions over a (k, n) cost matrix with ``capacity`` slots a
worker, it runs P phases: phase p > 0 first runs the eps-CS repair
(:func:`_repair`), then every phase runs rounds (:func:`_round_body`)
while a row of that auction is unassigned and fewer than ``max_rounds``
rounds of the phase have run, at the phase's eps.  It returns the final
state and the rounds of each phase.  It is the simulator's
``opt="auction"`` (B = 1, through
:func:`repro_torch.core.auction.auction_solve`) and the training step's
in-step ``Opt`` (B = n workers, through :func:`repro_torch.core.
dispatch.auction_fixed`).  Replaces the Pallas TPU kernel
``repro/kernels/auction.py:auction_bids`` together with the round and
phase loops around it in the JAX package (``core/auction.py:
_round_body``, ``_auction_phase``; ``kernels/ops.py:_resolve``,
``_phase``; ``core/dispatch_tpu.py:auction_fixed``).  It has two
routes, one kernel each, picked by :func:`solve_route` from the shape:
"warp" solves each auction in one warp (up to 256 rows, 8 workers and
32 slots a worker), "block" in one thread block (every other shape).
Both give the same bits.

:func:`auction_bids` — one round's bids, the arithmetic the fused
kernel shares (for every unassigned bidder row, its best worker against
the workers' cheapest slot prices, and its bid):

    value[i, j] = -cost[i, j] - min_price[j]
    best_j[i]   = argmax_j value[i, j]             (first on ties)
    w1, w2      = the best and the second-best value (w2 = w1 if n = 1)
    bid[i]      = min_price[best_j] + (w1 - w2) + eps,  NEG where assigned

It is held against its plain version on the card and runs on no driver
path.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/auction.cu``, which
states what bounds them and how the design answers it.  The wrappers
check device, dtype, shape and contiguity and raise on anything their
kernel does not take.  Given CUDA tensors they launch the kernel on the
current stream or raise; they run the plain version (``*_ref``) only
because the tensors lie on the CPU.  ``LAUNCHES`` counts kernel
launches (a solve counts under ``auction_solve`` on either route);
nothing else adds to it.  ``ROUNDS_LOG``, when set to a list, receives
each :func:`auction_solve` call's (B, P) rounds tensor, left where it
lies (appending reads nothing back from the card).
"""
from __future__ import annotations

import torch

from .emb_lookup import _check, _on_cuda, _raise_on

__all__ = ["NEG", "LAUNCHES", "ROUNDS_LOG", "SMEM_MAX", "auction_bids",
           "auction_bids_ref", "auction_solve", "auction_solve_ref",
           "solve_route", "solve_smem_bytes", "warp_auctions", "warp_fits",
           "warp_smem_bytes"]

NEG = -1e30
LAUNCHES = {"auction_bids": 0, "auction_solve": 0}
ROUNDS_LOG: list | None = None

_MAX_N = 12_288        # the bid kernel stages the price row in 48 KB
SMEM_MAX = 232_448     # shared memory a block can use on Hopper
_MAX_IDX = 1 << 16     # rows, slots a worker and workers: 16-bit key fields
_WARP_MAX_K = 256      # rows in the warp kernel's ballot masks: 8 a lane
_WARP_MAX_N = 8        # workers' cheapest prices and slots in registers
# the warp route's limit on slots a worker, from the crossover measured on
# the card: faster at c 32 (S1, 256 x 8), slower at c 64 (256 x 4)
WARP_ROUTE_C = 32


# --------------------------------------------------------------------------
# auction_bids
# --------------------------------------------------------------------------
def auction_bids_ref(cost: torch.Tensor, min_price: torch.Tensor,
                     unassigned: torch.Tensor, eps):
    """Plain PyTorch version of :func:`auction_bids`.

    Shape-generic over leading batch dims: cost (..., k, n), min_price
    (..., n), unassigned (..., k) bool, eps a float or a tensor that
    broadcasts against (..., k).  Returns best_j (..., k) int64 and bid
    (..., k) f32.  The best column is ``argmax`` (the first of equal
    values); w2 is the max over the row with that one column set to NEG.
    """
    n = cost.shape[-1]
    values = -cost - min_price[..., None, :]
    best_j = values.argmax(dim=-1)
    w1 = values.amax(dim=-1)
    w2 = (w1 if n == 1 else
          values.scatter(-1, best_j[..., None], NEG).amax(dim=-1))
    bid = torch.gather(min_price, -1, best_j) + (w1 - w2) + eps
    return best_j, torch.where(unassigned, bid, NEG)


def auction_bids(cost: torch.Tensor, min_price: torch.Tensor,
                 unassigned: torch.Tensor, eps: torch.Tensor):
    """Bids of one auction round.

    cost: (k, n) f32; min_price: (n,) f32, each worker's cheapest slot
    price; unassigned: (k,) bool; eps: the phase's eps, a one-element f32
    tensor on the same device.  Returns (best_j (k,) int32, bid (k,) f32,
    NEG where assigned).
    """
    _check("cost", cost, torch.float32, (None, None))
    k, n = cost.shape
    if n == 0:
        raise ValueError("auction_bids needs at least one worker column")
    _check("min_price", min_price, torch.float32, (n,))
    _check("unassigned", unassigned, torch.bool, (k,))
    if not isinstance(eps, torch.Tensor) or eps.dtype != torch.float32 \
            or eps.numel() != 1:
        raise TypeError("eps must be a one-element float32 tensor")
    if not _on_cuda(cost, min_price, unassigned, eps):
        best_j, bid = auction_bids_ref(cost, min_price, unassigned,
                                       eps.reshape(()))
        return best_j.to(torch.int32), bid
    if n > _MAX_N:
        raise ValueError(f"auction_bids takes at most {_MAX_N} workers, "
                         f"got {n}")
    best_j = torch.empty((k,), dtype=torch.int32, device=cost.device)
    bid = torch.empty((k,), dtype=torch.float32, device=cost.device)
    if k == 0:
        return best_j, bid
    from ._build import load_library

    lib = load_library("auction")
    rc = lib.auction_bids_launch(
        cost.data_ptr(), min_price.data_ptr(), unassigned.data_ptr(),
        eps.data_ptr(), best_j.data_ptr(), bid.data_ptr(), k, n,
        torch.cuda.current_stream(cost.device).cuda_stream)
    _raise_on(rc, "auction_bids")
    LAUNCHES["auction_bids"] += 1
    return best_j, bid


# --------------------------------------------------------------------------
# the plain round, repair and solve (B independent auctions batched)
# --------------------------------------------------------------------------
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
    matching.  cost: (B, k, n); eps: (B,)."""
    assign, slot_prices, _ = state
    best_j, bid = auction_bids_ref(cost, slot_prices.amin(dim=2),
                                   assign < 0, eps[:, None])
    return _resolve(state, best_j, bid)


def _repair(cost: torch.Tensor, eps: torch.Tensor, state):
    """eps-CS repair (reference ``_repair``): reprice ownerless slots to
    zero, then unassign every owner whose net value at its slot falls
    more than eps below its best alternative.  cost: (B, k, n); eps:
    (B,)."""
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


def auction_solve_ref(cost: torch.Tensor, capacity: int, eps: torch.Tensor,
                      max_rounds: int):
    """Plain PyTorch version of :func:`auction_solve`: the reference's
    phase and round loops over :func:`_repair` and :func:`_round_body`,
    the B auctions batched.  A round of an auction with no unassigned row
    changes nothing (every bid is NEG), so the batch runs while any
    auction has an unassigned row, and each auction counts only its own
    rounds."""
    B, k, n = cost.shape
    dev = cost.device
    state = (torch.full((B, k), -1, dtype=torch.int32, device=dev),
             torch.zeros((B, n, capacity), dtype=torch.float32, device=dev),
             torch.full((B, n, capacity), -1, dtype=torch.int32, device=dev))
    rounds = torch.zeros(eps.shape, dtype=torch.int32, device=dev)
    for p in range(eps.shape[1]):
        e = eps[:, p]
        if p:
            state = _repair(cost, e, state)
        for _ in range(max_rounds):
            active = (state[0] < 0).any(dim=1)
            if not bool(active.any()):
                break
            rounds[:, p] += active.to(torch.int32)
            state = _round_body(cost, e, state)
    return (*state, rounds)


# --------------------------------------------------------------------------
# auction_solve: the fused whole-solve kernel
# --------------------------------------------------------------------------
def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _align8(x: int) -> int:
    return (x + 7) & ~7


def solve_smem_bytes(k: int, n: int, capacity: int, with_cost: bool) -> int:
    """Shared memory of one block of :func:`auction_solve`, as
    ``csrc/auction.cu:solve_layout`` lays it out: bid keys, the bidder
    list (aliased by the slot keys), 256 bidder ranks, the state, the
    per-worker rows, counters, and the cost matrix where it fits."""
    nc = n * capacity
    total = (8 * _pow2(k) + _align8(max(4 * k, 8 * _pow2(nc))) + 4 * 256
             + 2 * _align8(4 * nc) + _align8(4 * k) + 3 * _align8(4 * n)
             + 16)
    return total + (4 * k * n if with_cost else 0)


def warp_smem_bytes(k: int, n: int, capacity: int) -> int:
    """Shared memory of one warp of the warp route, as
    ``csrc/auction.cu:warp_layout`` lays it out: a round's bid keys (at
    most k), the cost matrix, the slots' prices, price keys, owners,
    order and ranks, the rows' workers and slots, and a round's bidder
    rows."""
    nc = n * capacity
    return (8 * k + _align8(4 * k * n) + 5 * _align8(4 * nc)
            + 3 * _align8(4 * k))


def warp_fits(k: int, n: int, capacity: int) -> bool:
    """Whether the warp kernel takes an auction of this shape: at most
    256 rows (8 a lane in its ballot masks) and 8 workers (their cheapest
    prices and slots in registers)."""
    return (k <= _WARP_MAX_K and 1 <= n <= _WARP_MAX_N and capacity >= 1
            and warp_smem_bytes(k, n, capacity) <= SMEM_MAX)


def solve_route(k: int, n: int, capacity: int) -> str:
    """The route :func:`auction_solve` takes on the card for B auctions
    of k rows, n workers and ``capacity`` slots a worker: "warp" where
    the warp kernel takes the shape and ``capacity`` is at most
    ``WARP_ROUTE_C`` (its slot ranks then fit one shuffle pass), else
    "block"."""
    if capacity <= WARP_ROUTE_C and warp_fits(k, n, capacity):
        return "warp"
    return "block"


def warp_auctions(cost: torch.Tensor, capacity: int) -> int:
    """How many of ``cost``'s (B, k, n) auctions :func:`auction_solve`
    solves on the warp route: B on the card where :func:`solve_route`
    picks it, 0 otherwise (on the CPU the plain version runs)."""
    B, k, n = cost.shape
    if not cost.is_cuda or solve_route(k, n, capacity) != "warp":
        return 0
    return B


def auction_solve(cost: torch.Tensor, capacity: int, eps: torch.Tensor,
                  max_rounds: int):
    """B independent eps-scaled auctions, each solved whole.

    cost: (B, k, n) f32; capacity: slots a worker; eps: (B, P) f32, the
    eps of each auction's P phases; max_rounds: the rounds a phase may
    run.  Returns (assign (B, k) int32, -1 where a row stayed
    unassigned; slot prices (B, n, capacity) f32; slot owners (B, n,
    capacity) int32; rounds (B, P) int32).  On the card one launch, on
    the route :func:`solve_route` picks from (k, n, capacity).
    """
    _check("cost", cost, torch.float32, (None, None, None))
    B, k, n = cost.shape
    _check("eps", eps, torch.float32, (B, None))
    if n == 0 or capacity < 1:
        raise ValueError(f"auction_solve needs a worker and a slot, got "
                         f"n={n}, capacity={capacity}")
    if max(k, n + 1, capacity) > _MAX_IDX:
        raise ValueError(f"auction_solve takes k, capacity <= {_MAX_IDX} "
                         f"and n < {_MAX_IDX}, got k={k}, n={n}, "
                         f"capacity={capacity}")
    smem = solve_smem_bytes(k, n, capacity, False)
    if smem > SMEM_MAX:
        raise ValueError(f"auction_solve at k={k}, n={n}, capacity="
                         f"{capacity} needs {smem} bytes of shared memory "
                         f"a block, above the card's {SMEM_MAX}")
    if not _on_cuda(cost, eps):
        out = auction_solve_ref(cost, capacity, eps, max_rounds)
    else:
        out = _launch_solve(cost, capacity, eps, max_rounds,
                            solve_route(k, n, capacity))
    if ROUNDS_LOG is not None:
        ROUNDS_LOG.append(out[3])
    return out


def _launch_solve(cost, capacity, eps, max_rounds, route):
    """One launch of the route's kernel ("warp" or "block"); the caller
    has checked the inputs."""
    B, k, n = cost.shape
    P = eps.shape[1]
    dev = cost.device
    assign = torch.empty((B, k), dtype=torch.int32, device=dev)
    prices = torch.empty((B, n, capacity), dtype=torch.float32, device=dev)
    owners = torch.empty((B, n, capacity), dtype=torch.int32, device=dev)
    rounds = torch.empty((B, P), dtype=torch.int32, device=dev)
    if route not in ("warp", "block"):
        raise ValueError(f"unknown auction_solve route {route!r}")
    if route == "warp" and not warp_fits(k, n, capacity):
        raise ValueError(f"the warp route does not take k={k}, n={n}, "
                         f"capacity={capacity}")
    if B == 0:
        return assign, prices, owners, rounds
    from ._build import load_library

    lib = load_library("auction")
    ptrs = (cost.data_ptr(), eps.data_ptr(), assign.data_ptr(),
            prices.data_ptr(), owners.data_ptr(), rounds.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "warp":
        rc = lib.auction_solve_warp_launch(
            *ptrs, B, k, n, capacity, P, max_rounds,
            warp_smem_bytes(k, n, capacity), stream)
    else:
        with_cost = solve_smem_bytes(k, n, capacity, True) <= SMEM_MAX
        rc = lib.auction_solve_launch(
            *ptrs, B, k, n, capacity, P, max_rounds, int(with_cost),
            solve_smem_bytes(k, n, capacity, with_cost), stream)
    _raise_on(rc, "auction_solve")
    LAUNCHES["auction_solve"] += 1
    return assign, prices, owners, rounds
