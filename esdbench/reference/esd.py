"""Alg. 1's cost, the sample exchange and the cache protocol, in numpy,
written from the paper's description (arXiv:2512.21615, Alg. 1 and
Sec. 4) over dense (workers, vocabulary) planes.

The protocol, one BSP iteration over the ids each worker trains:
  A. update push: a dirty holder pushes an id that another worker
     trains; once pushed, only the pushers keep their latest copy (none
     does when two or more pushed);
  B. miss pull: a worker pulls every trained id it holds no latest copy
     of;
  C. train: the trainers hold it dirty and latest, every other worker's
     copy goes stale; the trainers' access stamp is the step.
Then each worker keeps at most ``capacity`` ids, the most recently used
by (stamp, id), and every id trained this step; an evicted id that was
latest and dirty is pushed back (evict push).

Alg. 2's objective: each source splits its m samples m / n to a worker;
the least Alg.-1 total such a split can reach, in
f64: :func:`best_split` reaches it by cancelling negative cycles from a
greedy start.
"""
from __future__ import annotations

import numpy as np

__all__ = ["alg1_costs", "exchange", "greedy", "best_split",
           "CacheState"]


def alg1_costs(samples: np.ndarray, latest: np.ndarray, dirty: np.ndarray,
               t: np.ndarray) -> np.ndarray:
    """Alg. 1 (m, n) in f64 for one worker's (m, W) samples (PAD -1):
    sample s on worker j costs, over its distinct ids v, a pull when j
    holds no latest copy (t_j) plus every other dirty holder's push
    (t_i)."""
    t = np.asarray(t, np.float64)
    s = np.sort(samples, axis=1)
    distinct = s >= 0
    distinct[:, 1:] &= s[:, 1:] != s[:, :-1]
    ids = np.where(distinct, s, 0)
    lat = latest[:, ids] & distinct[None]                 # (n, m, W)
    dirt = (dirty[:, ids] & distinct[None]).sum(axis=2).T * t   # (m, n)
    pull = (distinct.sum(axis=1)[:, None] - lat.sum(axis=2).T) * t
    push = dirt.sum(axis=1, keepdims=True) - dirt
    return pull + push


def greedy(C: np.ndarray, cap: int) -> np.ndarray:
    """Rows by regret (the gap between their two cheapest workers), each
    to its cheapest worker with room under ``cap``: (m,) workers."""
    top2 = np.sort(C, axis=1)[:, :2]
    order = np.argsort(-(top2[:, 1] - top2[:, 0]), kind="stable")
    load = np.zeros(C.shape[1], np.int64)
    out = np.zeros(C.shape[0], np.int64)
    for r in order:
        for j in np.argsort(C[r], kind="stable"):
            if load[j] < cap:
                load[j] += 1
                out[r] = j
                break
    return out


def _negative_cycle(D: np.ndarray, tol: float):
    """A cycle of workers whose moves sum below ``-tol`` in the (n, n)
    graph of move costs ``D`` (Bellman-Ford from every node at once), or
    None."""
    n = D.shape[0]
    dist = np.zeros(n)
    pred = np.full(n, -1)
    for _ in range(n):
        cand = dist[:, None] + D                  # via a to b
        a = np.argmin(cand, axis=0)
        best = cand[a, np.arange(n)]
        better = best < dist - tol
        if not better.any():
            return None
        dist = np.where(better, best, dist)
        pred = np.where(better, a, pred)
    # the last pass still relaxed: walk back n steps into the cycle
    v = int(np.flatnonzero(better)[0])
    for _ in range(n):
        v = int(pred[v])
    cycle = [v]
    u = int(pred[v])
    while u != v:
        cycle.append(u)
        u = int(pred[u])
    cycle.reverse()
    w = sum(D[cycle[i], cycle[(i + 1) % len(cycle)]]
            for i in range(len(cycle)))
    return cycle if w < -tol else None


def best_split(C: np.ndarray, cap: int) -> np.ndarray:
    """(m,) workers of the least total of an (m, n) cost matrix over the
    assignments that give every worker exactly ``cap`` rows (m = n *
    cap), exact in f64: from the greedy split, move one row along each worker cycle whose
    moves cost less than nothing, until none is left (a split with no
    such cycle is optimal: min-cost flow's cycle condition)."""
    m, n = C.shape
    C = np.asarray(C, np.float64)
    x = greedy(C, cap)
    tol = 1e-12 * max(float(np.abs(C).sum()), 1e-300)
    rows = np.arange(m)
    while True:
        rel = C - C[rows, x][:, None]         # (m, n): move row r to b
        mine = np.argsort(x, kind="stable").reshape(n, cap)
        R = rel[mine]                          # (n, cap, n)
        r = R.argmin(axis=1)                   # the cheapest move a -> b
        D = np.take_along_axis(R, r[:, None, :], axis=1)[:, 0, :]
        arg = np.take_along_axis(mine, r, axis=1)
        np.fill_diagonal(D, np.inf)
        cycle = _negative_cycle(D, tol)
        if cycle is None:
            return x
        moves = [(arg[a, b], b) for a, b in
                 zip(cycle, cycle[1:] + cycle[:1])]
        for r, b in moves:
            x[r] = b


def exchange(blocks, assign: np.ndarray, n: int):
    """Each destination's rows: over ascending source, that source's rows
    assigned there, in their order.  ``blocks``: arrays (n, m, ...);
    returns the (n * m, ...) concatenation over destinations, or None
    where a destination does not receive exactly m rows."""
    m = assign.shape[1]
    outs = []
    for a in blocks:
        dest = []
        for j in range(n):
            rows = [a[i][assign[i] == j] for i in range(n)]
            got = np.concatenate(rows, axis=0)
            if got.shape[0] != m:
                return None
            dest.append(got)
        outs.append(np.concatenate(dest, axis=0))
    return outs


class CacheState:
    """The replicated cache state of ``n`` workers over ``vocab`` ids:
    dense (n, vocab) planes, of which a step reads and writes only the
    columns of the ids trained in it, and each worker's cache."""

    def __init__(self, n: int, vocab: int, capacity):
        self.n, self.vocab, self.capacity = n, vocab, capacity
        self.latest = np.zeros((n, vocab), bool)
        self.dirty = np.zeros((n, vocab), bool)
        self.stamp = np.zeros((n, vocab), np.int64)
        self.cached = np.zeros((n, vocab), bool)
        self.step = 0

    def update(self, trained: list) -> dict:
        """One iteration; ``trained[j]`` the distinct ids worker j
        trains.  Returns the (n,) counts of each kind of transfer."""
        n = self.n
        self.step += 1
        # the step touches only the ids someone trains: their columns
        U = np.unique(np.concatenate([np.asarray(v, np.int64)
                                      for v in trained]))
        need = np.zeros((n, U.size), bool)
        for j, ids in enumerate(trained):
            need[j, np.searchsorted(U, ids)] = True
        cnt = need.sum(axis=0)
        latest, dirty = self.latest[:, U], self.dirty[:, U]
        # A. update push
        other = ~(need & (cnt == 1)[None, :])
        pushers = dirty & other
        update_push = pushers.sum(axis=1)
        n_push = pushers.sum(axis=0)
        latest &= ~((n_push > 0)[None, :] & ~pushers)
        latest &= ~(n_push > 1)[None, :]
        dirty &= ~pushers
        # B. miss pull
        miss_pull = (need & ~latest).sum(axis=1)
        latest |= need
        # C. train
        dirty |= need
        latest &= need
        self.latest[:, U], self.dirty[:, U] = latest, dirty
        self.stamp[:, U] = np.where(need, self.step, self.stamp[:, U])
        # the LRU cut: the lowest (stamp, id) go, never this step's ids
        evict_push = np.zeros(n, np.int64)
        for j in range(n):
            self.cached[j, trained[j]] = True
            if self.capacity is None:
                continue
            cand = np.flatnonzero(self.cached[j])
            excess = cand.size - self.capacity
            if excess <= 0:
                continue
            key = self.stamp[j, cand] * self.vocab + cand
            gone = cand[np.argpartition(key, excess - 1)[:excess]]
            gone = gone[self.stamp[j, gone] != self.step]
            evict_push[j] = int((self.latest[j, gone]
                                 & self.dirty[j, gone]).sum())
            self.latest[j, gone] = False
            self.dirty[j, gone] = False
            self.cached[j, gone] = False
        return {"miss_pull": miss_pull, "update_push": update_push,
                "evict_push": evict_push}
