"""Alg. 1's cost, the sample exchange and the cache protocol, in numpy,
written from the paper's description (arXiv:2512.21615, Alg. 1 and
Sec. 4) over dense planes of every worker and id.

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
    """The replicated cache state of ``n`` workers over ``vocab`` ids.

    The planes are held id-major, (vocab, n), so the columns a step
    reads and writes (the ids trained in it) are rows of n entries;
    ``latest`` and ``dirty`` give them as (n, vocab) views.  Each
    worker's cache is a row of ``cached`` with its count of ids, so the
    LRU cut looks for candidates only in a cache over its capacity."""

    def __init__(self, n: int, vocab: int, capacity):
        self.n, self.vocab, self.capacity = n, vocab, capacity
        self._latest = np.zeros((vocab, n), bool)
        self._dirty = np.zeros((vocab, n), bool)
        self._stamp = np.zeros((vocab, n), np.int64)
        self.cached = np.zeros((n, vocab), bool)
        self.n_cached = np.zeros(n, np.int64)
        self.step = 0

    @property
    def latest(self) -> np.ndarray:
        return self._latest.T

    @property
    def dirty(self) -> np.ndarray:
        return self._dirty.T

    @property
    def stamp(self) -> np.ndarray:
        return self._stamp.T

    def update(self, trained: list) -> dict:
        """One iteration; ``trained[j]`` the distinct ids worker j
        trains.  Returns the (n,) counts of each kind of transfer."""
        n = self.n
        self.step += 1
        trained = [np.asarray(v, np.int64) for v in trained]
        # the step touches only the ids someone trains: their rows
        U = np.unique(np.concatenate(trained))
        need = np.zeros((U.size, n), bool)
        for j, ids in enumerate(trained):
            need[np.searchsorted(U, ids), j] = True
        cnt = need.sum(axis=1)
        latest, dirty = self._latest[U], self._dirty[U]
        # A. update push
        other = ~(need & (cnt == 1)[:, None])
        pushers = dirty & other
        update_push = pushers.sum(axis=0)
        n_push = pushers.sum(axis=1)
        latest &= ~((n_push > 0)[:, None] & ~pushers)
        latest &= ~(n_push > 1)[:, None]
        dirty &= ~pushers
        # B. miss pull
        miss_pull = (need & ~latest).sum(axis=0)
        latest |= need
        # C. train
        dirty |= need
        latest &= need
        self._latest[U], self._dirty[U] = latest, dirty
        for j, ids in enumerate(trained):
            self._stamp[ids, j] = self.step
        # the LRU cut: the lowest (stamp, id) go, never this step's ids
        evict_push = np.zeros(n, np.int64)
        for j, ids in enumerate(trained):
            self.n_cached[j] += ids.size - int(self.cached[j, ids].sum())
            self.cached[j, ids] = True
            if self.capacity is None:
                continue
            excess = int(self.n_cached[j]) - self.capacity
            if excess <= 0:
                continue
            cand = np.flatnonzero(self.cached[j])
            key = self._stamp[cand, j] * self.vocab + cand
            gone = cand[np.argpartition(key, excess - 1)[:excess]]
            gone = gone[self._stamp[gone, j] != self.step]
            evict_push[j] = int((self._latest[gone, j]
                                 & self._dirty[gone, j]).sum())
            self._latest[gone, j] = False
            self._dirty[gone, j] = False
            self.cached[j, gone] = False
            self.n_cached[j] -= gone.size
        return {"miss_pull": miss_pull, "update_push": update_push,
                "evict_push": evict_push}
