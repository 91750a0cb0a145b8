"""Worker embedding caches + PS state machine (paper §3, Fig. 2, §8.1 Emark).

Tracks, for n workers over an id universe of size V:

  * ``present[j, x]`` — x is resident in worker j's cache.
  * ``latest[j, x]``  — the resident copy is the latest global version.
  * ``dirty[j, x]``   — worker j holds an unsynchronized gradient for x.

and executes one BSP iteration with on-demand synchronization in three
phases, counting the three transmission-operation types:

  A. *update push*  — a dirty holder pushes x's gradient iff some OTHER
     worker needs x this iteration (paper §3 on-demand sync).
  B. *miss pull*    — a needer whose copy is absent/outdated pulls x; cache
     insertion may evict victims, and evicting a dirty victim costs an
     *evict push*.
  C. train          — needed ids become dirty+latest on their worker; all
     other copies become stale.

Eviction policies: ``emark`` (§8.1: outdated first, then mark epoch, then
frequency), ``lru``, ``lfu``.  Ids needed by the current iteration are
pinned and never evicted.

Lookahead protection (``step(..., protect=ids)``): the pipeline's
sliding window (repro_torch.pipeline.window) knows which ids the next W
batches touch; passing them as ``protect`` makes the victim scan prefer
unprotected entries — a *soft* shield (protected ids are still evicted
when nothing else is left, so capacity pressure never fails), which is
how window dedup turns into fewer miss pulls under skew.  ``protect=None``
(default) is the unchanged bitwise path.

Passing an :class:`EvictPlan` (built from the window metadata) upgrades
the shield to a first/last-use-*exact* evict order: candidates without a
pending use inside the window go first (in policy order — among rows
Belady cannot distinguish the policy is the tie-break), then in-window
rows by *descending* next use, which is exactly Belady's farthest-in-
future rule over the announced horizon.  A plan also turns on the
prefetched-vs-demand miss split: a miss on an id the *previous* step's
plan announced was knowable at least one step early, so a window-driven
prefetcher could have pulled it overlapped with training
(``IterStats.miss_prefetched``); the remainder is unavoidable demand
traffic (``IterStats.miss_demand``).

Two engines:
  * :class:`ClusterCache` — dense reference: (n, V) boolean-plane algebra,
    O(n*V) per iteration.
  * :class:`SparseClusterCache` — touched-ids engine: identical protocol,
    accounting, and eviction decisions (equivalence-tested), but every
    per-iteration phase only reads/writes the <= k*F ids the iteration
    touches, and eviction scans the bounded resident set (<= capacity)
    instead of all V.  At paper scale (V = 1e6) this is the difference
    between vocab-bound and batch-bound simulation.

Multi-PS: built with ``part=`` (a :class:`repro_torch.ps.PsPartition`), a cache
runs on the PS-linearized id space (vocab == part.linear_size) and every
transmission op is additionally counted against the owning shard's link
(``IterStats.*_ps``), so the simulator can charge per-(worker, PS)
bandwidths.  ``part=None`` is the unchanged single-PS reference path.

Host-side numpy, copied line for line from the JAX package's module of
the same path, so both packages give the same results from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np

__all__ = ["ClusterCache", "SparseClusterCache", "IterStats", "EvictPlan",
           "Policy", "init_ps_stats", "ps_op_count"]

Policy = Literal["emark", "lru", "lfu"]


@dataclasses.dataclass(frozen=True)
class EvictPlan:
    """First/last-use-exact eviction plan from one window's metadata.

    ``uids`` must be sorted ascending; ``next_use``/``last_use`` are the
    window-relative first/last batch index touching each uid (0 = the
    very next batch).  An empty plan is the unchanged no-protect path.
    """

    uids: np.ndarray        # (U,) sorted ids (cache id space)
    next_use: np.ndarray    # (U,) first touching window batch per uid
    last_use: np.ndarray    # (U,) last touching window batch per uid

    @property
    def n(self) -> int:
        return int(self.uids.size)

    @classmethod
    def from_window(cls, meta) -> "EvictPlan":
        """Build from a :class:`repro_torch.pipeline.window.WindowMeta` (whose
        ``uids`` are already sorted)."""
        return cls(uids=meta.uids, next_use=meta.first_use,
                   last_use=meta.last_use)

    def linearize(self, part) -> "EvictPlan":
        """Map ids into ``part``'s PS-linear space (re-sorting, since the
        linear map is not monotone for hashed layouts)."""
        lin = part.to_linear(self.uids)
        order = np.argsort(lin, kind="stable")
        return EvictPlan(uids=lin[order], next_use=self.next_use[order],
                         last_use=self.last_use[order])


def init_ps_stats(stats: "IterStats", n: int, n_ps: int) -> None:
    """Zero the per-(worker, PS) breakdowns on ``stats`` (shared by every
    cache model that carries multi-PS accounting)."""
    shape = (n, n_ps)
    stats.miss_pull_ps = np.zeros(shape, np.int64)
    stats.update_push_ps = np.zeros(shape, np.int64)
    stats.evict_push_ps = np.zeros(shape, np.int64)


def ps_op_count(part, ids) -> np.ndarray:
    """(n_ps,) op count per owning shard for linear-space ``ids``."""
    return np.bincount(
        part.shard_of_linear(np.asarray(ids, np.int64)),
        minlength=part.n_ps).astype(np.int64)


@dataclasses.dataclass
class IterStats:
    """Per-iteration transmission counts, per worker.

    The ``*_ps`` fields are the per-(worker, parameter-server) breakdown,
    populated only when the cache was built with a ``part``
    (:class:`repro_torch.ps.PsPartition`); each row sums to the per-worker
    count.
    """

    miss_pull: np.ndarray     # (n,)
    update_push: np.ndarray   # (n,)
    evict_push: np.ndarray    # (n,)
    lookups: np.ndarray       # (n,) embedding lookups (for hit ratio)
    hits: np.ndarray          # (n,)
    miss_pull_ps: np.ndarray | None = None     # (n, n_ps)
    update_push_ps: np.ndarray | None = None   # (n, n_ps)
    evict_push_ps: np.ndarray | None = None    # (n, n_ps)
    # prefetched-vs-demand miss split, populated by the cluster-cache
    # engines when the caller passes EvictPlan protection (a miss is
    # "prefetched" when the previous step's plan announced the id, i.e.
    # a window prefetcher had >= 1 full step to pull it early)
    miss_prefetched: np.ndarray | None = None       # (n,)
    miss_demand: np.ndarray | None = None           # (n,)
    miss_prefetched_ps: np.ndarray | None = None    # (n, n_ps)
    miss_demand_ps: np.ndarray | None = None        # (n, n_ps)

    def cost(self, t_tran: np.ndarray) -> float:
        ops = self.miss_pull + self.update_push + self.evict_push
        return float((ops * t_tran).sum())

    def per_worker_cost(self, t_tran: np.ndarray) -> np.ndarray:
        return (self.miss_pull + self.update_push + self.evict_push) * t_tran

    def _ops_ps(self) -> np.ndarray:
        return self.miss_pull_ps + self.update_push_ps + self.evict_push_ps

    def cost_ps(self, t_ps: np.ndarray) -> float:
        """Total transmission cost under per-(worker, PS) link times."""
        return float((self._ops_ps() * t_ps).sum())

    def per_worker_time_ps(self, t_ps: np.ndarray) -> np.ndarray:
        """Per-worker wall time: PS links transfer in parallel, so the
        worker waits on its slowest shard, not the sum."""
        return (self._ops_ps() * t_ps).max(axis=1)


class ClusterCache:
    """Mutable cluster cache state (numpy, simulator-side)."""

    # per-PS capacity budgets are a touched-ids-engine feature (the dense
    # engine's O(V) victim scan has no per-shard bookkeeping)
    supports_capacity_ps = False

    def __init__(
        self,
        n_workers: int,
        vocab: int,
        capacity,
        policy: Policy = "emark",
        sync: Literal["on_demand", "eager"] = "on_demand",
        seed: int = 0,
        part=None,
    ):
        self.n = n_workers
        self.V = vocab
        if np.ndim(capacity) > 0:
            # per-PS worker-cache budgets: capacity[p] ids owned by shard
            # p per worker (requires part; sparse engine only)
            if part is None or part.n_ps != len(capacity):
                raise ValueError(
                    f"capacity_ps needs part with n_ps == {len(capacity)}")
            if not self.supports_capacity_ps:
                raise ValueError(
                    "per-PS capacity budgets need the SparseClusterCache "
                    "engine")
            self.capacity_ps = np.asarray(capacity, np.int64)
            self.capacity = int(self.capacity_ps.sum())
        else:
            self.capacity_ps = None
            self.capacity = int(capacity)
        self.policy: Policy = policy
        self.sync = sync   # "eager": push every dirty entry each iteration
                           # (HET-under-BSP per the paper's evaluation setup)
        # multi-PS accounting: when a PsPartition is attached, ids (and
        # vocab) are in its PS-linearized space and every op is also
        # counted against the owning shard's link (IterStats.*_ps).
        self.part = part
        if part is not None and part.n_ps > 1 and vocab != part.linear_size:
            raise ValueError(
                f"vocab {vocab} != part.linear_size {part.linear_size}: "
                "multi-PS caches run on the PS-linearized id space")
        self.present = np.zeros((self.n, vocab), bool)
        self.latest = np.zeros((self.n, vocab), bool)
        self.dirty = np.zeros((self.n, vocab), bool)
        self.freq = np.zeros((self.n, vocab), np.int32)
        self.last_access = np.zeros((self.n, vocab), np.int32)
        self.mark = np.zeros((self.n, vocab), np.int32)
        self.target = np.ones(self.n, np.int32)   # Emark epoch counter
        self.it = 0
        self._rng = np.random.default_rng(seed)
        # ids the previous step's EvictPlan announced (sorted) — the
        # basis of the prefetched-vs-demand miss split
        self._announced: np.ndarray | None = None

    # -- views used by Alg. 1 ------------------------------------------------
    @property
    def latest_in_cache(self) -> np.ndarray:
        return self.present & self.latest

    def snapshot(self):
        """Cache snapshots used by the dispatcher (paper §5)."""
        return self.latest_in_cache.copy(), self.dirty.copy()

    def state_columns(self, uids: np.ndarray):
        """(latest_in_cache[:, uids], dirty[:, uids]) — the touched-ids
        view Alg. 1 needs, without materializing a dense snapshot."""
        return (self.present[:, uids] & self.latest[:, uids],
                self.dirty[:, uids])

    # -- one BSP iteration ---------------------------------------------------
    def step(self, batches: Sequence[np.ndarray],
             protect: "np.ndarray | tuple | None" = None) -> IterStats:
        """Run one iteration; ``batches[j]`` = unique ids needed by worker j.

        ``protect``: optional lookahead shield the victim scan evicts
        last — a sorted id array, a ``(sorted_ids, next_use)`` pair, or
        an :class:`EvictPlan` for the first/last-use-exact order plus
        the prefetched-vs-demand miss split (grading described on
        ``_select_victims``)."""
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
        self._init_split(stats)

        # ---- Phase A: update push ------------------------------------------
        need_any = need.any(axis=0)                      # (V,)
        need_other = need_any[None, :] & ~(
            need & (need.sum(axis=0) == 1)[None, :]
        )  # worker j' sees a needer other than itself
        if self.sync == "eager":
            pushers = self.dirty.copy()                  # full-set sync
        else:
            pushers = self.dirty & need_other            # (n, V) on-demand
        stats.update_push += pushers.sum(axis=1)
        if self.part is not None:
            # V == n_ps * max_rows: columns group by shard contiguously
            stats.update_push_ps += pushers.reshape(
                n, self.part.n_ps, -1).sum(axis=2)
        pushed = pushers.any(axis=0)                     # (V,)
        multi = pushers.sum(axis=0) > 1
        # after a push the PS holds the newest value: every non-pushing copy
        # is stale; with multiple simultaneous pushers (merged at PS) all
        # local copies are stale.
        self.latest &= ~(pushed[None, :] & ~pushers) & ~multi[None, :]
        self.dirty &= ~pushers

        # hits are measured after the on-demand sync, as in the paper's
        # hit-ratio definition ("latest version already cached")
        stats.hits += (need & self.present & self.latest).sum(axis=1)

        # ---- Phase B: miss pull (+ evictions) ------------------------------
        for j in range(n):
            ids = np.where(need[j])[0]
            if not len(ids):
                continue
            have = self.present[j, ids] & self.latest[j, ids]
            miss_ids = ids[~have]
            stats.miss_pull[j] += len(miss_ids)
            self._split_miss(j, miss_ids, stats)
            if self.part is not None:
                stats.miss_pull_ps[j] += self._ps_count(miss_ids)
            # refresh stale-resident entries in place (no eviction needed)
            resident_stale = miss_ids[self.present[j, miss_ids]]
            self.latest[j, resident_stale] = True
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
                    if len(vdirty):
                        # evict-push publishes new versions: other copies stale
                        self.dirty[j, vdirty] = False
                        others = np.arange(n) != j
                        self.latest[np.ix_(others, vdirty)] = False
                    self.present[j, victims] = False
                    self.latest[j, victims] = False
                self.present[j, new_ids] = True
                self.latest[j, new_ids] = True

        # ---- Phase C: train ------------------------------------------------
        for j in range(n):
            ids = np.where(need[j])[0]
            if not len(ids):
                continue
            self.dirty[j, ids] = True
            self.latest[j, ids] = True
            self.freq[j, ids] += 1
            self.last_access[j, ids] = self.it
            self.mark[j, ids] = self.target[j]
        # copies on workers that did NOT train x become stale
        trained = need.any(axis=0)
        self.latest &= ~(trained[None, :] & ~need)
        self._finish_split(stats, protect)
        return stats

    # -- multi-PS accounting helpers -----------------------------------------
    def _init_ps_stats(self, stats: IterStats):
        if self.part is not None:
            init_ps_stats(stats, self.n, self.part.n_ps)

    def _ps_count(self, ids) -> np.ndarray:
        return ps_op_count(self.part, ids)

    # -- prefetched-vs-demand miss split -------------------------------------
    def _init_split(self, stats: IterStats):
        stats.miss_prefetched = np.zeros(self.n, np.int64)
        if self.part is not None:
            stats.miss_prefetched_ps = np.zeros((self.n, self.part.n_ps),
                                                np.int64)

    def _split_miss(self, j: int, miss_ids: np.ndarray, stats: IterStats):
        """Count how many of worker j's misses the previous step's plan
        announced (a window prefetcher could have hidden them)."""
        a = self._announced
        if a is None or not len(a) or not len(miss_ids):
            return
        pos = np.minimum(np.searchsorted(a, miss_ids), len(a) - 1)
        pre = miss_ids[a[pos] == miss_ids]
        stats.miss_prefetched[j] += len(pre)
        if stats.miss_prefetched_ps is not None:
            stats.miss_prefetched_ps[j] += self._ps_count(pre)

    def _finish_split(self, stats: IterStats, protect):
        stats.miss_demand = stats.miss_pull - stats.miss_prefetched
        if stats.miss_prefetched_ps is not None:
            stats.miss_demand_ps = (stats.miss_pull_ps
                                    - stats.miss_prefetched_ps)
        self._announced = (protect.uids if isinstance(protect, EvictPlan)
                           else None)

    # -- eviction ------------------------------------------------------------
    def _pick_victims(self, j: int, pinned: np.ndarray, count: int,
                      protect: "np.ndarray | tuple | None" = None
                      ) -> np.ndarray:
        cand = np.where(self.present[j] & ~pinned)[0]
        resident = np.where(self.present[j])[0]
        return self._select_victims(j, cand, resident, count, protect=protect)

    def _select_victims(self, j: int, cand: np.ndarray, resident: np.ndarray,
                        count: int,
                        protect: "np.ndarray | tuple | None" = None
                        ) -> np.ndarray:
        """Shared victim-selection core (dense + sparse engines): cand must
        be sorted ascending so argpartition tie-breaks are engine-invariant.

        ``protect`` applies the soft lookahead shield — either a sorted id
        array (uniform shield) or a ``(sorted_ids, next_use)`` pair from
        the window metadata.  A key shift puts every protected candidate
        after every unprotected one while preserving the within-class
        policy order, so protected ids are evicted only once the
        unprotected pool is exhausted; with ``next_use`` distances the
        shield grades Belady-style — among protected candidates the one
        reused *farthest* in the future goes first, so a longer window
        strictly refines the decision instead of flattening it.  Only
        *latest* resident copies earn the shield — a stale copy of a
        soon-reused id misses on its next use regardless, so keeping it
        over a cold entry buys nothing.

        An :class:`EvictPlan` makes the order *exact*: an integer
        lexicographic sort (no float key-shift arithmetic) that takes
        no-pending-use candidates first in policy order, then in-window
        latest copies by descending next use — Belady's rule over the
        announced horizon, with the policy key only breaking ties the
        oracle cannot see.  An empty plan falls through to the plain
        (bitwise-identical) no-protect scan."""
        if len(cand) < count:
            raise RuntimeError(
                f"worker {j}: cannot evict {count} of {len(cand)} candidates "
                "(capacity too small for one batch)"
            )
        key = self._evict_key(j, cand)
        if isinstance(protect, EvictPlan):
            if protect.n and len(cand):
                pos = np.minimum(np.searchsorted(protect.uids, cand),
                                 protect.n - 1)
                hit = (protect.uids[pos] == cand) & self.latest[j, cand]
                nxt = np.where(hit, protect.next_use[pos], -1)
                # stable lexsort; cand is sorted ascending, so residual
                # ties break by id identically in both engines
                order = np.lexsort((key, -nxt, hit))
                victims = cand[order[:count]]
            else:
                victims = cand[np.argpartition(key, count - 1)[:count]]
            if self.policy == "emark":
                if (self.mark[j, resident] >= self.target[j]).all():
                    self.target[j] += 1
            return victims
        p_ids, p_next = (protect if isinstance(protect, tuple)
                         else (protect, None))
        if p_ids is not None and len(p_ids) and len(cand):
            pos = np.minimum(np.searchsorted(p_ids, cand), len(p_ids) - 1)
            shielded = (p_ids[pos] == cand) & self.latest[j, cand]
            if shielded.any():
                off = float(key.max() - key.min()) + 1.0
                if p_next is None:
                    key = key + shielded * off
                else:
                    # urgency in [1, W]: next use in the very next batch
                    # shifts the most, the window's far edge the least
                    W = int(p_next.max()) + 1 if len(p_next) else 1
                    key = key + np.where(shielded,
                                         (W - p_next[pos]) * off, 0.0)
        victims = cand[np.argpartition(key, count - 1)[:count]]
        if self.policy == "emark":
            # Emark epoch bump: when every cached mark equals target, target+=1
            if (self.mark[j, resident] >= self.target[j]).all():
                self.target[j] += 1
        return victims

    def _evict_key(self, j: int, cand: np.ndarray) -> np.ndarray:
        """Smaller key == evicted first."""
        if self.policy == "lru":
            return self.last_access[j, cand].astype(np.float64)
        if self.policy == "lfu":
            return self.freq[j, cand].astype(np.float64)
        # Emark §8.1: version (outdated first) > mark epoch > frequency
        version = self.latest[j, cand].astype(np.float64)     # 0 outdated, 1 latest
        mark = self.mark[j, cand].astype(np.float64)
        freq = self.freq[j, cand].astype(np.float64)
        fmax = float(freq.max()) + 1.0
        mmax = float(self.target[j]) + 1.0
        return (version * mmax * fmax * 2.0) + (mark * fmax) + freq

    # -- elastic membership (repro.elastic) ----------------------------------
    def crash(self, worker: int, graceful: bool = False) -> dict:
        """Remove worker ``worker`` from the cluster.

        ``graceful=True`` models an announced departure: the worker first
        pushes every dirty row to the PS (an update-push per row — the
        returned ``flushed`` ids/counts let the simulator charge it), so
        other copies of those ids go stale exactly as in phase A; its
        remaining ``present & latest`` rows are returned as ``inventory``
        for a :func:`repro.elastic.membership.departure_handoff`.

        A hard crash (default) drops the unsynced gradients silently —
        the PS's pre-gradient version becomes canonical (no worker keeps
        ``latest`` for those ids once the crasher's rows are cleared;
        the next needer re-pulls the old value, which is exactly the
        lost-update semantics of a real failure).

        Either way the worker's plane rows are zeroed (a rejoin is cold
        unless warmed by a handoff) and its Emark clock resets.
        """
        j = worker
        out = {"flushed": np.zeros(0, np.int64),
               "inventory": np.zeros(0, np.int64)}
        if self.part is not None:
            out["flushed_ps"] = np.zeros(self.part.n_ps, np.int64)
        if graceful:
            flushed = np.where(self.dirty[j])[0].astype(np.int64)
            if len(flushed):
                others = np.arange(self.n) != j
                self.latest[np.ix_(others, flushed)] = False
                self.dirty[j, flushed] = False
                out["flushed"] = flushed
                if self.part is not None:
                    out["flushed_ps"] = self._ps_count(flushed)
            out["inventory"] = np.where(
                self.present[j] & self.latest[j])[0].astype(np.int64)
        self.present[j] = False
        self.latest[j] = False
        self.dirty[j] = False
        self.freq[j] = 0
        self.last_access[j] = 0
        self.mark[j] = 0
        self.target[j] = 1
        self._clear_worker(j)
        return out

    def seed_rows(self, worker: int, ids: np.ndarray) -> np.ndarray:
        """Admit latest & clean copies of ``ids`` (priority order) into
        worker ``worker``'s *free* capacity — no evictions, already
        present ids are skipped.  Returns the ids actually seeded.

        This is the receiving half of a cache handoff: callers pass ids
        some peer holds present & latest & clean, so marking the new
        copies ``latest`` is sound.  Seeded rows carry a fresh
        ``last_access`` but mark epoch 0 — under Emark a gift row is the
        first eviction candidate until the worker actually uses it.
        """
        j = worker
        ids = np.asarray(ids, np.int64)
        if not len(ids):
            return ids
        new = ids[~self.present[j, ids]]
        free = self.capacity - int(self.present[j].sum())
        sel = new[: max(free, 0)]
        if len(sel):
            self.present[j, sel] = True
            self.latest[j, sel] = True
            self.last_access[j, sel] = self.it
            self._note_seeded(j, sel)
        return sel

    def _clear_worker(self, j: int) -> None:
        """Subclass hook: drop per-worker side structures on crash."""

    def _note_seeded(self, j: int, sel: np.ndarray) -> None:
        """Subclass hook: record freshly seeded ids in side structures."""

    # -- warm start ----------------------------------------------------------
    def prefill(self, hot_ids: np.ndarray):
        """Fill every cache with (up to capacity) given ids, latest & clean."""
        ids = np.asarray(hot_ids)[: self.capacity]
        self.present[:, :] = False
        self.latest[:, :] = False
        self.dirty[:, :] = False
        self.present[:, ids] = True
        self.latest[:, ids] = True


class SparseClusterCache(ClusterCache):
    """Touched-ids cluster cache: same protocol and accounting as
    :class:`ClusterCache`, but each iteration only reads/writes the ids it
    touches.

    The (n, V) planes are kept as O(1)-lookup *storage* (so states remain
    directly comparable with the dense engine) while all per-iteration
    *compute* is restricted to gathered columns, and eviction candidates
    come from the per-worker resident set (<= capacity ids) instead of an
    O(V) scan.  Under ``sync="eager"`` the touched universe additionally
    includes every dirty id (the full-set sync pushes them all).

    Per-PS budgets: built with ``capacity=[cap_0, ..., cap_{n_ps-1}]``
    (and ``part=``), each worker keeps at most ``cap_p`` ids owned by
    shard ``p`` — admission and eviction run per shard over per-shard
    resident sets, so one hot shard can no longer starve the others'
    cache share.  The Emark epoch bump stays cache-wide (it is a
    per-worker clock, not a per-shard one).  A plain int is the
    unchanged (bitwise) single-budget path.
    """

    supports_capacity_ps = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._resident = [set() for _ in range(self.n)]
        self._dirtyset = [set() for _ in range(self.n)]
        if self.capacity_ps is not None:
            self._resident_ps = [[set() for _ in range(self.part.n_ps)]
                                 for _ in range(self.n)]

    # -- one BSP iteration ---------------------------------------------------
    def step(self, batches: Sequence[np.ndarray],
             protect: "np.ndarray | tuple | None" = None) -> IterStats:
        n = self.n
        self.it += 1
        # dense `step` scatters batches into a bool plane, which both
        # de-duplicates and sorts; np.unique gives the same set semantics.
        batches = [np.unique(np.asarray(ids, dtype=np.int64))
                   for ids in batches]
        parts = [b for b in batches if len(b)]
        if self.sync == "eager":
            dirty_union = set().union(*self._dirtyset) if any(self._dirtyset) else set()
            if dirty_union:
                parts.append(np.fromiter(dirty_union, np.int64, len(dirty_union)))
        touched = (np.unique(np.concatenate(parts)) if parts
                   else np.zeros(0, np.int64))
        U = len(touched)

        needU = np.zeros((n, U), bool)
        for j, ids in enumerate(batches):
            if len(ids):
                needU[j, np.searchsorted(touched, ids)] = True

        stats = IterStats(
            miss_pull=np.zeros(n, np.int64),
            update_push=np.zeros(n, np.int64),
            evict_push=np.zeros(n, np.int64),
            lookups=np.array([len(b) for b in batches], np.int64),
            hits=np.zeros(n, np.int64),
        )
        self._init_ps_stats(stats)
        self._init_split(stats)
        if U == 0:
            self._finish_split(stats, protect)
            return stats

        latU = self.latest[:, touched]
        dirU = self.dirty[:, touched]
        presU = self.present[:, touched]

        # ---- Phase A: update push (on touched columns only) ----------------
        need_any = needU.any(axis=0)
        sole = needU & (needU.sum(axis=0) == 1)[None, :]
        need_other = need_any[None, :] & ~sole
        pushers = dirU.copy() if self.sync == "eager" else dirU & need_other
        stats.update_push += pushers.sum(axis=1)
        if self.part is not None:
            shard_t = self.part.shard_of_linear(touched)
            for j in range(n):
                stats.update_push_ps[j] += np.bincount(
                    shard_t[pushers[j]], minlength=self.part.n_ps)
        pushed = pushers.any(axis=0)
        multi = pushers.sum(axis=0) > 1
        latU &= ~(pushed[None, :] & ~pushers) & ~multi[None, :]
        dirU &= ~pushers
        self.latest[:, touched] = latU
        self.dirty[:, touched] = dirU
        for j in range(n):
            if pushers[j].any():
                self._dirtyset[j].difference_update(
                    touched[pushers[j]].tolist())

        stats.hits += (needU & presU & latU).sum(axis=1)

        # ---- Phase B: miss pull (+ bounded-candidate evictions) ------------
        for j in range(n):
            ids = batches[j]
            if not len(ids):
                continue
            have = self.present[j, ids] & self.latest[j, ids]
            miss_ids = ids[~have]
            stats.miss_pull[j] += len(miss_ids)
            self._split_miss(j, miss_ids, stats)
            if self.part is not None:
                stats.miss_pull_ps[j] += self._ps_count(miss_ids)
            resident_stale = miss_ids[self.present[j, miss_ids]]
            self.latest[j, resident_stale] = True
            new_ids = miss_ids[~self.present[j, miss_ids]]
            if len(new_ids):
                self._admit(j, ids, new_ids, stats, protect=protect)

        # ---- Phase C: train ------------------------------------------------
        for j in range(n):
            ids = batches[j]
            if not len(ids):
                continue
            self.dirty[j, ids] = True
            self._dirtyset[j].update(ids.tolist())
            self.latest[j, ids] = True
            self.freq[j, ids] += 1
            self.last_access[j, ids] = self.it
            self.mark[j, ids] = self.target[j]
        # copies on workers that did NOT train x become stale — only
        # touched columns can change
        lat = self.latest[:, touched]
        lat &= ~(need_any[None, :] & ~needU)
        self.latest[:, touched] = lat
        self._finish_split(stats, protect)
        return stats

    # -- admission (+ bounded-candidate evictions) ---------------------------
    def _admit(self, j: int, pinned_ids: np.ndarray, new_ids: np.ndarray,
               stats: IterStats,
               protect: "np.ndarray | tuple | None" = None):
        """Insert ``new_ids`` into worker j's cache, evicting per budget.

        With a single capacity this is one admission over the whole set
        (the original, bitwise-unchanged path); with per-PS budgets the
        new ids are admitted shard by shard against ``capacity_ps[p]``.
        """
        n = self.n
        if self.capacity_ps is None:
            groups = [(None, new_ids)]
        else:
            shard_new = self.part.shard_of_linear(new_ids)
            groups = [(p, new_ids[shard_new == p])
                      for p in range(self.part.n_ps)]
        for p, ids_p in groups:
            if not len(ids_p):
                continue
            if p is None:
                free = self.capacity - len(self._resident[j])
            else:
                free = int(self.capacity_ps[p]) - len(self._resident_ps[j][p])
            overflow = len(ids_p) - free
            if overflow > 0:
                victims = self._pick_victims_sparse(j, pinned_ids, overflow,
                                                    shard=p, protect=protect)
                vdirty = victims[self.dirty[j, victims]]
                stats.evict_push[j] += len(vdirty)
                if self.part is not None:
                    stats.evict_push_ps[j] += self._ps_count(vdirty)
                if len(vdirty):
                    self.dirty[j, vdirty] = False
                    self._dirtyset[j].difference_update(vdirty.tolist())
                    others = np.arange(n) != j
                    self.latest[np.ix_(others, vdirty)] = False
                self.present[j, victims] = False
                self.latest[j, victims] = False
                self._resident[j].difference_update(victims.tolist())
                if p is not None:
                    self._resident_ps[j][p].difference_update(victims.tolist())
            self.present[j, ids_p] = True
            self.latest[j, ids_p] = True
            self._resident[j].update(ids_p.tolist())
            if p is not None:
                self._resident_ps[j][p].update(ids_p.tolist())

    def _pick_victims_sparse(self, j: int, pinned_ids: np.ndarray,
                             count: int, shard: int | None = None,
                             protect: "np.ndarray | tuple | None" = None
                             ) -> np.ndarray:
        # sorted ascending so keys (and argpartition tie-breaks) line up
        # exactly with the dense engine's np.where scan order
        pool = (self._resident[j] if shard is None
                else self._resident_ps[j][shard])
        cand_set = pool.difference(pinned_ids.tolist())
        cand = np.fromiter(cand_set, np.int64, len(cand_set))
        cand.sort()
        # the Emark epoch bump ranges over the whole cache either way
        resident = np.fromiter(self._resident[j], np.int64,
                               len(self._resident[j]))
        return self._select_victims(j, cand, resident, count, protect=protect)

    # -- elastic membership (repro.elastic) ----------------------------------
    def seed_rows(self, worker: int, ids: np.ndarray) -> np.ndarray:
        if self.capacity_ps is None:
            return super().seed_rows(worker, ids)
        # per-PS budgets: fill each shard's free slots in priority order
        j = worker
        ids = np.asarray(ids, np.int64)
        if not len(ids):
            return ids
        new = ids[~self.present[j, ids]]
        shard = self.part.shard_of_linear(new)
        take = np.zeros(len(new), bool)
        for p in range(self.part.n_ps):
            free_p = int(self.capacity_ps[p]) - len(self._resident_ps[j][p])
            idx = np.where(shard == p)[0]
            take[idx[: max(free_p, 0)]] = True
        sel = new[take]
        if len(sel):
            self.present[j, sel] = True
            self.latest[j, sel] = True
            self.last_access[j, sel] = self.it
            self._note_seeded(j, sel)
        return sel

    def _clear_worker(self, j: int) -> None:
        self._resident[j] = set()
        self._dirtyset[j] = set()
        if self.capacity_ps is not None:
            self._resident_ps[j] = [set() for _ in range(self.part.n_ps)]

    def _note_seeded(self, j: int, sel: np.ndarray) -> None:
        self._resident[j].update(sel.tolist())
        if self.capacity_ps is not None:
            shard = self.part.shard_of_linear(sel)
            for p in range(self.part.n_ps):
                self._resident_ps[j][p].update(sel[shard == p].tolist())

    # -- warm start ----------------------------------------------------------
    def prefill(self, hot_ids: np.ndarray):
        if self.capacity_ps is None:
            super().prefill(hot_ids)
            ids = np.asarray(hot_ids)[: self.capacity].tolist()
            self._resident = [set(ids) for _ in range(self.n)]
        else:
            # per-shard budgets: take the hottest ids of each shard
            hot = np.asarray(hot_ids)
            shard = self.part.shard_of_linear(hot)
            keep = [hot[shard == p][: int(self.capacity_ps[p])]
                    for p in range(self.part.n_ps)]
            ids = np.concatenate(keep) if keep else hot[:0]
            self.present[:, :] = False
            self.latest[:, :] = False
            self.dirty[:, :] = False
            self.present[:, ids] = True
            self.latest[:, ids] = True
            self._resident = [set(ids.tolist()) for _ in range(self.n)]
            self._resident_ps = [[set(k.tolist()) for k in keep]
                                 for _ in range(self.n)]
        self._dirtyset = [set() for _ in range(self.n)]
