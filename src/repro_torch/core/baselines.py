"""Baseline dispatch/caching mechanisms the paper compares against (§6.1).

* :class:`LAIA`  — embedding scheduling by sample↔worker relevance score
  (cache-hit count), greedy highest-score with workload caps [79].
* :class:`RandomDispatch` — vanilla round-robin/random micro-batching.
* HET / FAE change the *consistency protocol*, not just dispatch; they are
  modeled by :class:`HETCache` (bounded-staleness reads & lazy writes) and
  :class:`FAECache` (static hot set replicated on all workers, AllReduce
  sync; cold ids go PS-direct) in this module, both driven by random
  dispatch as in their papers.

Host-side numpy, copied line for line from the JAX package's module of
the same path, so both packages give the same results from one seed.
"""
from __future__ import annotations

import numpy as np

from .cache import ClusterCache, IterStats, init_ps_stats, ps_op_count
from .heu import heu_dispatch

__all__ = ["laia_dispatch", "random_dispatch", "random_dispatch_active",
           "HETCache", "FAECache"]


def laia_dispatch(
    samples: np.ndarray,
    latest_in_cache: np.ndarray,
    maxworkload: int,
    active: np.ndarray | None = None,
) -> np.ndarray:
    """LAIA: dispatch each sample to the worker with the highest relevance
    score = number of its ids already cached (latest), under workload caps.

    Implemented as greedy max-score == greedy min(-score) with the same
    capacity fall-through as Heu.  ``active`` (elastic clusters) sinks
    dead workers' scores so no sample lands on them — the caller must
    raise ``maxworkload`` so the survivors can absorb the load."""
    k, F = samples.shape
    valid = samples >= 0
    ids = np.where(valid, samples, 0)
    hits = latest_in_cache[:, ids]                      # (n, k, F)
    score = (hits & valid[None]).sum(axis=2).T.astype(np.float64)  # (k, n)
    if active is not None and not np.asarray(active, bool).all():
        score = np.where(np.asarray(active, bool)[None, :], score, -1e18)
    # process highest-scoring rows first so strong affinities win slots
    order = np.argsort(-score.max(axis=1), kind="stable")
    return heu_dispatch(-score, maxworkload, order=order)


def random_dispatch(k: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """Vanilla dispatch: random permutation into n equal micro-batches."""
    assign = np.repeat(np.arange(n), k // n)
    rng.shuffle(assign)
    return assign


def random_dispatch_active(k: int, active: np.ndarray,
                           rng: np.random.Generator) -> np.ndarray:
    """Random dispatch over the active workers only: k samples split as
    evenly as integers allow across ``active.sum()`` workers, then
    shuffled.  With every worker active the repeat layout (and hence the
    shuffled result for a given rng state) is exactly
    :func:`random_dispatch` — the no-fault path stays bitwise-pinned."""
    active = np.asarray(active, bool)
    act = np.where(active)[0]
    n_a = len(act)
    if n_a == 0:
        raise ValueError("no active workers to dispatch to")
    counts = np.full(n_a, k // n_a, np.int64)
    counts[: k - int(counts.sum())] += 1
    assign = np.repeat(act, counts)
    rng.shuffle(assign)
    return assign


class HETCache(ClusterCache):
    """HET [45]: per-embedding version clocks with bounded staleness.

    Reads use a resident copy whose version lag <= ``staleness`` without
    pulling; a dirty entry is pushed only when its unsynced-update count
    reaches ``staleness`` (or on eviction).  Dispatch is random.  This
    trades accuracy for fewer transmissions (the paper runs HET under BSP,
    where it loses its advantage).

    Multi-PS: built with ``part=`` (ids in the PS-linearized space) every
    op is additionally counted against the owning shard's link
    (``IterStats.*_ps``), like the version-tracked caches."""

    def __init__(self, *args, staleness: int = 2, **kw):
        super().__init__(*args, **kw)
        self.staleness = int(staleness)
        self.lag = np.zeros((self.n, self.V), np.int32)
        self.dirty_cnt = np.zeros((self.n, self.V), np.int32)

    def step(self, batches, protect=None) -> IterStats:
        n, V = self.n, self.V
        self.it += 1
        need = np.zeros((n, V), bool)
        for j, ids in enumerate(batches):
            if len(ids):
                need[j, np.asarray(ids)] = True
        stats = IterStats(
            miss_pull=np.zeros(n, np.int64),
            update_push=np.zeros(n, np.int64),
            evict_push=np.zeros(n, np.int64),
            lookups=need.sum(axis=1).astype(np.int64),
            hits=np.zeros(n, np.int64),
        )
        self._init_ps_stats(stats)
        # lazy write-back: push entries whose local update count hit the bound
        push = self.dirty & (self.dirty_cnt >= self.staleness)
        stats.update_push += push.sum(axis=1)
        if self.part is not None:
            # V == n_ps * max_rows: linear-space columns group by shard
            stats.update_push_ps += push.reshape(
                n, self.part.n_ps, -1).sum(axis=2)
        if push.any():
            pushed_any = push.any(axis=0)
            # copies held elsewhere fall one version behind the pushed value
            self.lag += (pushed_any[None, :] & self.present & ~push).astype(np.int32)
            self.dirty &= ~push
            self.dirty_cnt[push] = 0

        usable = self.present & (self.lag <= self.staleness)
        stats.hits += (need & usable).sum(axis=1)
        for j in range(n):
            ids = np.where(need[j])[0]
            if not len(ids):
                continue
            miss_ids = ids[~usable[j, ids]]
            stats.miss_pull[j] += len(miss_ids)
            if self.part is not None:
                stats.miss_pull_ps[j] += self._ps_count(miss_ids)
            resident = miss_ids[self.present[j, miss_ids]]
            self.lag[j, resident] = 0
            new_ids = miss_ids[~self.present[j, miss_ids]]
            if len(new_ids):
                free = self.capacity - int(self.present[j].sum())
                overflow = len(new_ids) - free
                if overflow > 0:
                    victims = self._pick_victims(j, need[j], overflow,
                                                 protect=protect)
                    vdirty = victims[self.dirty[j, victims]]
                    stats.evict_push[j] += len(vdirty)
                    if self.part is not None:
                        stats.evict_push_ps[j] += self._ps_count(vdirty)
                    self.dirty[j, victims] = False
                    self.dirty_cnt[j, victims] = 0
                    self.present[j, victims] = False
                self.present[j, new_ids] = True
                self.lag[j, new_ids] = 0
            # train
            self.dirty[j, ids] = True
            self.dirty_cnt[j, ids] += 1
            self.freq[j, ids] += 1
            self.last_access[j, ids] = self.it
        # staleness clock: copies on workers that did not train tick forward
        trained = need.any(axis=0)
        self.lag += (trained[None, :] & self.present & ~need).astype(np.int32)
        return stats

    def _evict_key(self, j, cand):  # LRU inside HET
        return self.last_access[j, cand].astype(np.float64)

    def _clear_worker(self, j: int) -> None:
        # HET's extra per-worker clocks reset with the plane rows
        self.lag[j] = 0
        self.dirty_cnt[j] = 0


class FAECache:
    """FAE [4]: top-popular ids (offline profile) replicated on every worker
    and synchronized with AllReduce; cold ids are accessed PS-direct
    (pull + push per use).  Static — no runtime cache management.

    Multi-PS: with ``part=`` (ids in the PS-linearized space) cold
    pulls/pushes are counted against the owning shard's link, and the
    hot-set AllReduce legs are charged at the shard that homes each hot
    id (the reduced values still have to reach/leave that server)."""

    def __init__(self, n_workers: int, vocab: int, capacity: int,
                 hot_ids: np.ndarray, part=None):
        self.n = n_workers
        self.V = vocab
        self.part = part
        if part is not None and part.n_ps > 1 and vocab != part.linear_size:
            raise ValueError(
                f"vocab {vocab} != part.linear_size {part.linear_size}: "
                "multi-PS caches run on the PS-linearized id space")
        self.hot = np.zeros(vocab, bool)
        self.hot[np.asarray(hot_ids)[:capacity]] = True

    @property
    def latest_in_cache(self) -> np.ndarray:
        return np.tile(self.hot[None, :], (self.n, 1))

    def snapshot(self):
        return self.latest_in_cache, np.zeros((self.n, self.V), bool)

    def _ps_count(self, ids) -> np.ndarray:
        return ps_op_count(self.part, ids)

    def step(self, batches, protect=None) -> IterStats:
        # protect is accepted for interface parity; FAE's hot set is
        # static (replicated, never evicted), so the shield is a no-op
        n = self.n
        stats = IterStats(
            miss_pull=np.zeros(n, np.int64),
            update_push=np.zeros(n, np.int64),
            evict_push=np.zeros(n, np.int64),
            lookups=np.zeros(n, np.int64),
            hits=np.zeros(n, np.int64),
        )
        if self.part is not None:
            init_ps_stats(stats, n, self.part.n_ps)
        for j, ids in enumerate(batches):
            ids = np.asarray(ids)
            stats.lookups[j] = len(ids)
            hot = self.hot[ids]
            stats.hits[j] = int(hot.sum())
            cold = int((~hot).sum())
            stats.miss_pull[j] += cold          # pull cold from PS
            stats.update_push[j] += cold        # push cold grad back
            # sparse AllReduce of this worker's trained hot gradients:
            # send own contributions + receive the reduced values
            stats.update_push[j] += 2 * int(hot.sum())
            if self.part is not None:
                cold_ps = self._ps_count(ids[~hot])
                stats.miss_pull_ps[j] += cold_ps
                stats.update_push_ps[j] += cold_ps + 2 * self._ps_count(ids[hot])
        return stats
