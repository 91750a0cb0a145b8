"""Elastic membership: dispatch around dead and slow workers at fixed
shapes, plus cache-state handoff when workers depart or rejoin.

The counterpart of the JAX package's ``elastic/membership.py``.  A dead
(or straggling) worker is a worker whose expected cost went to
(effectively) infinity.  The dispatch stages take two per-step inputs,
both of shape (n,), so membership churn changes values, never shapes:

  * :func:`cost_column_bias` — a per-worker additive bias on the Alg.-1
    cost matrix.  Active workers pay their *excess* compute time
    ``(compute_factor - 1) * compute_s`` (a healthy worker pays exactly
    0.0, keeping the no-fault path bitwise-identical).  Inactive workers
    pay a large-but-FINITE penalty scale-matched to the worst possible
    sample cost — finite because the auction's eps-scaling reads the
    cost span, and an ``inf``/1e9 column would wreck its numerics for
    every other column.
  * :func:`mask_state` — zeros a dead worker's rows in the cache-state
    planes, so its stale cache contents stop feeding phase-A pushes and
    cost columns (its PS copy is canonical while it is away; on rejoin
    it is cold unless warmed by a handoff).

Both take numpy arrays (the simulator, the driver's host side) or torch
tensors on any device (the training stages), and answer in the kind
they were given: the reference's ``_xp`` switch between numpy and
``jax.numpy``, here between numpy and torch.

Cache handoff compiles departures/rejoins into the same per-link rows
shape the exchange layer prices (:class:`HandoffPlan`): a *graceful*
departure distributes the leaver's clean inventory round-robin into the
survivors' free capacity; a *warm* rejoin seeds the returning worker
from the peers' hottest clean-latest rows.  Both go through the numpy
cache engines' ``seed_rows`` (``core.cache``), so capacity budgets
(incl. per-PS) hold.  This part is the reference's numpy, line for line.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..exchange.plan import bucket_sizes
from ..obs.trace import traced

__all__ = ["cost_column_bias", "mask_state", "HandoffPlan",
           "departure_handoff", "rejoin_handoff"]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cost_column_bias(t_tran, n_fields: int, active,
                     compute_factor=None, compute_s: float = 0.0):
    """(n,) additive per-worker bias for the Alg.-1 cost matrix.

    ``C_elastic[i, j] = C[i, j] + bias[j]`` where

      * active j:   ``bias[j] = (compute_factor[j] - 1) * compute_s``
        — the straggler's excess compute per sample, priced jointly with
        comm (0.0 exactly for a healthy worker, so adding it is bitwise
        identity: costs are >= 0, no -0.0 cases);
      * inactive j: a finite penalty ``16 * n_fields * sum(t_tran) +
        16 * compute_s * max(compute_factor)`` — 16x the most expensive
        sample any state could produce, so no assignment ever prefers a
        dead worker while the cost span stays within what the auction's
        eps-scaling tolerates.

    ``t_tran`` may be the (n,) single-PS vector or the (n, n_ps) matrix;
    only its sum enters.  Returns float64: numpy for a numpy ``active``,
    a tensor on ``active``'s device for a tensor (``t_tran`` and
    ``compute_factor`` are then read on the host) — cast to the cost
    dtype at the point of use.
    """
    t_sum = float(_np(t_tran).astype(np.float64).sum())
    if compute_factor is None:
        slow = np.zeros(np.shape(active), np.float64)
        fmax = 1.0
    else:
        cf = _np(compute_factor).astype(np.float64)
        slow = (cf - 1.0) * compute_s
        fmax = float(cf.max())
    penalty = 16.0 * n_fields * t_sum + 16.0 * compute_s * fmax
    if isinstance(active, torch.Tensor):
        slow = torch.as_tensor(slow, dtype=torch.float64,
                               device=active.device)
        return torch.where(active.bool(), slow, penalty)
    return np.where(np.asarray(active, bool), slow, penalty)


def mask_state(state, active):
    """Mask a cache state (either engine's:
    :class:`repro_torch.core.dispatch.SparseEsdState` or
    :class:`repro_torch.core.dispatch.EsdState`, or any dataclass with
    the same planes) to the active workers.

    Inactive rows lose ``latest`` and ``dirty`` (the PS copy is
    canonical while the worker is away — its unsynced gradients are
    gone, its cached values no longer count as hits and must not feed
    phase-A pushes), and ``last_access`` goes to 0; on the sparse engine
    its ``slots`` go to PAD so a cold rejoiner re-admits from scratch
    instead of resurrecting pre-crash slot contents.

    The planes may be numpy arrays or torch tensors (``active`` then a
    tensor on their device, or numpy moved there).  With all workers
    active every plane keeps its exact value (``x & True == x``), which
    is what pins the no-fault path bitwise.
    """
    if isinstance(state.latest, torch.Tensor):
        active = torch.as_tensor(active, dtype=torch.bool,
                                 device=state.latest.device)
        where = torch.where
    else:
        active = np.asarray(active, bool)
        where = np.where
    act = active[:, None]
    repl = {"latest": state.latest & act, "dirty": state.dirty & act,
            "last_access": where(act, state.last_access, 0)}
    if hasattr(state, "slots"):
        repl["slots"] = where(act, state.slots, -1)
    return dataclasses.replace(state, **repl)


@dataclasses.dataclass(frozen=True)
class HandoffPlan:
    """One membership transition compiled to per-link row movements —
    the same (src, dst) shape the exchange layer prices, so the
    simulator charges handoff traffic with the exact NIC model it uses
    for sample exchange."""

    kind: str                 # "departure" | "rejoin"
    worker: int               # the leaver / rejoiner
    link_rows: np.ndarray     # (n, n) embedding rows moved src -> dst
    row_bytes: float          # bytes per embedding row (d * 4)

    @property
    def rows(self) -> int:
        """Total embedding rows moved."""
        return int(self.link_rows.sum())

    @property
    def payload_bytes(self) -> float:
        return self.rows * self.row_bytes

    @property
    def wire_rows(self) -> int:
        """Pow2-bucketed on-wire rows (same quantization as the ragged
        exchange executor's blocks)."""
        return int(bucket_sizes(self.link_rows).sum())

    def link_bytes(self) -> np.ndarray:
        """(n, n) wire bytes per link (bucketed)."""
        return bucket_sizes(self.link_rows) * self.row_bytes


@traced("cache.handoff.departure", track="elastic")
def departure_handoff(cache, worker: int, inventory: np.ndarray, active,
                      row_bytes: float = 4.0) -> HandoffPlan:
    """Distribute a graceful leaver's clean inventory to the survivors.

    ``inventory`` is the id set ``ClusterCache.crash(..., graceful=True)``
    returned (present & latest after the dirty flush).  Ids go
    round-robin across the active peers; each peer admits only what its
    free capacity takes (``seed_rows``), so the handoff never evicts —
    it is a warm-up gift, not a displacement.
    """
    n = cache.n
    active = np.asarray(active, bool)
    link_rows = np.zeros((n, n), np.int64)
    peers = np.where(active)[0]
    peers = peers[peers != worker]
    inventory = np.asarray(inventory, np.int64)
    if len(peers) and len(inventory):
        for i, peer in enumerate(peers):
            seeded = cache.seed_rows(int(peer), inventory[i::len(peers)])
            link_rows[worker, peer] = len(seeded)
    return HandoffPlan("departure", worker, link_rows, row_bytes)


@traced("cache.handoff.rejoin", track="elastic")
def rejoin_handoff(cache, worker: int, active,
                   row_bytes: float = 4.0) -> HandoffPlan:
    """Warm a rejoining worker from its peers' hottest clean rows.

    Candidates are ids some active peer holds present & latest & clean
    (a dirty row's latest value exists only as an unsynced gradient —
    shipping it would fork versions).  Ranked by total access frequency
    across the donors, seeded into the rejoiner up to its free capacity,
    and each seeded id is attributed to its first active holder for
    link accounting.
    """
    n = cache.n
    active = np.asarray(active, bool)
    link_rows = np.zeros((n, n), np.int64)
    donors = np.where(active)[0]
    donors = donors[donors != worker]
    if len(donors):
        clean = (cache.present[donors] & cache.latest[donors]
                 & ~cache.dirty[donors])                       # (p, V)
        cand = np.where(clean.any(axis=0))[0]
        if len(cand):
            hot = cache.freq[donors][:, cand].sum(axis=0)
            order = np.argsort(-hot, kind="stable")
            seeded = cache.seed_rows(worker, cand[order])
            if len(seeded):
                holder = donors[np.argmax(clean[:, seeded], axis=0)]
                np.add.at(link_rows, (holder, worker), 1)
    return HandoffPlan("rejoin", worker, link_rows, row_bytes)
