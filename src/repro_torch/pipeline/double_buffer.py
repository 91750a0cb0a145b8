"""Double-buffered ESD cache state and its staleness analysis.

The counterpart of the JAX package's ``pipeline/double_buffer.py``.  The
pipelined executor (:mod:`repro_torch.pipeline.runner`) lets the
dispatch decision for step t+1 run while step t trains.  In the *exact*
mode the decision reads the state committed by step t's cache update;
in the *stale* mode it reads the state of step t-1 instead, removing
its dependency on step t's update at the price of deciding on a
slightly out-of-date cost matrix.

:class:`DoubleBuffer` holds the two slots: ``front`` is the committed
state after the latest advance, ``back`` the one before it;
:func:`db_commit` rotates them.

Between the decide-time and the commit-time state only the columns
touched by the intervening step can differ (its need ids and its
evictions; :func:`changed_ids` recovers the set from two states).  A
sample's Alg.-1 cost is the sum of its ids' per-id cost rows, and one
id's row can swing by at most the sum of the per-link row times, so

    |C_stale[i, j] - C_true[i, j]|  <=  |ids(E_i) ∩ changed| * sum_j T_j

for every worker j (:func:`staleness_bound`; with per-(worker, PS)
links the swing of id x refines to sum_j t_ps[j, shard(x)]).  The
analysis functions are host-side numpy, copied line for line from the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.cost import dedup_mask_np

__all__ = ["DoubleBuffer", "db_init", "db_commit", "changed_ids",
           "staleness_bound", "staleness_bound_chain"]


@dataclasses.dataclass
class DoubleBuffer:
    """Two-slot ESD state: ``front`` = committed state after step t,
    ``back`` = state after step t-1 (what a stale decide reads)."""

    front: Any
    back: Any


def db_init(state) -> DoubleBuffer:
    """Both slots start at the initial state (steps 0 and 1 decide on it)."""
    return DoubleBuffer(front=state, back=state)


def db_commit(db: DoubleBuffer, new_state) -> DoubleBuffer:
    """Rotate: the committed state moves to ``back``, ``new_state`` becomes
    ``front``."""
    return DoubleBuffer(front=new_state, back=db.front)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def changed_ids(state_a, state_b) -> np.ndarray:
    """Ids whose cache-state column differs between two cache states
    (either engine's).

    Compares the planes the Alg.-1 cost matrix reads (``latest``,
    ``dirty``).  For consecutive states this is exactly the intervening
    step's need ids plus its evictions — the support of any stale-decision
    error.  An analysis and test helper (O(n*V)); the runner never calls
    it.
    """
    la, lb = _np(state_a.latest), _np(state_b.latest)
    da, db_ = _np(state_a.dirty), _np(state_b.dirty)
    diff = (la != lb).any(axis=0) | (da != db_).any(axis=0)
    return np.where(diff)[0].astype(np.int64)


def staleness_bound(samples: np.ndarray, changed: np.ndarray,
                    t_tran: np.ndarray, part=None) -> np.ndarray:
    """(k,) per-sample upper bound on the stale-decision cost error.

    For every worker j, ``|C_stale[i, j] - C_true[i, j]| <= bound[i]``
    where C_* are Alg.-1 cost matrices computed from two states that
    differ only on the ``changed`` id columns.  Each changed id of a
    sample counts once (``dedup_mask_np``), exactly as it enters C.

    With ``part`` and a per-(worker, PS) ``t_tran`` of shape (n, n_ps),
    the per-id swing refines to ``sum_j t_tran[j, shard(x)]`` (ids and
    samples in the PS-linearized space).
    """
    samples = np.asarray(samples)
    t_tran = np.asarray(t_tran, np.float64)
    ids, mask = dedup_mask_np(samples)
    changed = np.asarray(changed)
    in_changed = np.isin(ids, changed) & mask             # (k, F)
    if part is None:
        if t_tran.ndim != 1:
            raise ValueError("per-(worker, PS) t_tran needs part=")
        return in_changed.sum(axis=1) * float(t_tran.sum())
    if t_tran.ndim != 2:
        raise ValueError("part= needs a per-(worker, PS) t_tran of shape "
                         f"(n, n_ps), got shape {t_tran.shape}")
    per_shard = t_tran.sum(axis=0)                        # (n_ps,)
    swing = per_shard[part.shard_of_linear(ids)]          # (k, F)
    return (swing * in_changed).sum(axis=1)


def staleness_bound_chain(samples: np.ndarray, changed_seq,
                          t_tran: np.ndarray, part=None) -> np.ndarray:
    """(k,) per-sample bound on the cost error of a decide-ahead chain.

    A decision issued A steps ahead reads a state that A commits have
    since mutated; by the triangle inequality its error is at most the
    sum of :func:`staleness_bound` over the per-commit changed-id sets
    ``changed_seq`` (oldest first).  An empty sequence bounds the error
    by zero.  The sets are not merged: an id flipped by two commits
    contributes its swing twice, where a union would under-count.
    """
    samples = np.asarray(samples)
    total = np.zeros(len(samples), np.float64)
    for changed in changed_seq:
        total += staleness_bound(samples, changed, t_tran, part=part)
    return total
