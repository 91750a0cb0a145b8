"""The auction's bid phase: wrapper and plain version.

:func:`auction_bids` — for every unassigned bidder row, its best worker
against the workers' cheapest slot prices, and its bid:

    value[i, j] = -cost[i, j] - min_price[j]
    best_j[i]   = argmax_j value[i, j]             (first on ties)
    w1, w2      = the best and the second-best value (w2 = w1 if n = 1)
    bid[i]      = min_price[best_j] + (w1 - w2) + eps,  NEG where assigned

It is the row-parallel half of one round of the eps-scaled auction
(:func:`repro_torch.core.auction.auction_solve`): the paper's parallel
``Opt``.  Replaces the Pallas TPU kernel ``repro/kernels/auction.py:
auction_bids``.  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/auction.cu``, which states what bounds it and how its design
answers it.

The wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take.  Given CUDA tensors it launches the
kernel on the current stream or raises; it runs the plain version
(:func:`auction_bids_ref`) only because the tensors lie on the CPU.
``LAUNCHES`` counts kernel launches: the wrapper's, and those of the
CUDA graphs that :func:`replay` runs, each of which holds one launch of
the kernel (the solver captures a round once and replays it); a call
made while a graph is being captured launches nothing and counts
nothing.
"""
from __future__ import annotations

import torch

from .emb_lookup import _check, _on_cuda, _raise_on

__all__ = ["NEG", "LAUNCHES", "auction_bids", "auction_bids_ref", "replay"]

NEG = -1e30
LAUNCHES = {"auction_bids": 0}

_MAX_N = 12_288   # the price row stages in 48 KB of shared memory


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
    tensor on the same device (read by the kernel, so a captured round
    serves any eps).  Returns (best_j (k,) int32, bid (k,) f32, NEG where
    assigned).
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
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["auction_bids"] += 1
    return best_j, bid


def replay(graph) -> None:
    """Replay a CUDA graph that holds one launch of the bid kernel (one
    captured auction round) and count that launch."""
    graph.replay()
    LAUNCHES["auction_bids"] += 1
