"""Paper-faithful ESD simulator: n edge workers + 1 PS, BSP + on-demand sync.

Drives the cache state machine with a chosen dispatch mechanism over a
synthetic CTR stream and accounts the paper's metrics:

  * total embedding transmission Cost  (Eq. 3, heterogeneous T_j)
  * Iterations-per-Second (ItpS): with the decision pipelined
    (``pipeline_depth >= 2``, the paper's setup and the default),
    per-iteration wall time is
      max(compute_time + max_j comm_time_j,  decision_time)
    because ESD hides the decision for iteration t+1 under iteration t —
    once the decision takes longer than an iteration, it becomes the
    bottleneck (paper §6.5 batch-size analysis).  ``pipeline_depth = 1``
    models the synchronous loop instead: the two stages *sum*, which is
    what the repro.pipeline runner removes.
  * hit ratio, and the miss-pull/update-push/evict-push ingredient split
    per bandwidth class (Fig. 5).

Lookahead (``SimConfig.lookahead = W > 0``): the batch stream is wrapped
in repro.pipeline.window.LookaheadWindow and the window's first/last-use
oracle becomes an *exact* eviction plan (``cache.step(protect=
EvictPlan)``): candidates with no pending use in the window evict first
(policy order), then in-window rows by farthest next use — Belady's rule
on the W-step horizon, replacing the old soft shield.  Window dedup
turns into real miss-op reduction exactly as the cache engine reports
it, no analytic discount.  The engines also split each step's misses
into *prefetched* (the id was announced in the previous step's plan, so
a window-driven prefetcher had a full step to pull it early) vs *demand*
(first seen now — its wire latency is unhideable).  This split is the
*unbounded-budget* bound on hideability; the training driver
(``--prefetch B``) reports the budgeted real split its staging plane
achieves.  ``SimConfig.prefetch
= True`` prices that split into the timing model: demand pulls stay on
the training critical path while prefetched pulls move to a prefetch
stage that overlaps training (per-iteration time becomes
``max(train_stage, decision, prefetch_pull)`` at depth >= 2).
``SimResult.pipeline`` carries the stage breakdown, the dedup
accounting, and the miss split.

Decision time: "calibrated" (default) interpolates the paper's Table 2
GPU-parallel Hungarian latencies — we are simulating their testbed, and
this container's 1-core solver wall time would misattribute hardware, not
mechanism (CPU solver times are reported separately in benchmarks/table2).
"measured" uses the actual dispatch wall clock instead.

Engine: ``SimConfig.engine="sparse"`` (default) runs the touched-ids
cost/cache engine — Alg. 1 from gathered state columns and the
incremental SparseClusterCache — making each iteration O(k*F) instead of
O(n*V), so paper-scale vocabularies (V = 1e6, n = 16) simulate in
seconds.  ``engine="dense"`` keeps the original full-plane reference path
(equivalence-tested: identical assignments, counts, and costs).

Multi-PS (``n_ps > 1`` or ``ps_bandwidths`` set): the embedding space is
partitioned over n_ps parameter servers (``repro.ps.PsPartition``,
``ps_layout`` contiguous|hashed), every transmission op is charged at the
owning shard's link (``ps_bandwidths[j, p]``), and a worker's
per-iteration comm time is the max over the shards it touched (links
transfer in parallel).  ``hetero_ps_bandwidths`` builds the skewed-links
scenario (one slow PS, rest fast) the paper's heterogeneous-network
experiments correspond to.  All mechanisms carry per-PS accounting
(the FAE / stale-HET baseline caches included).

Sample exchange (``SimConfig.exchange``): with ``"padded"`` or
``"ragged"`` the per-iteration wall time also charges the worker-to-
worker sample exchange the dispatch implies, using the compiled plan's
exact byte accounting (repro.exchange.plan): the padded baseline ships
one uniform block per link (the max per-link count), the ragged path
ships the pow2-bucketed schedule — so comm time follows planned bytes,
not worst-case padding.  Each (src, dst) link is priced individually at
the slower end's bandwidth (an edge transfer cannot outrun either NIC),
a worker's wall time serializes its own sends and receives, and the
self-link (src == dst) is a local copy that costs no wire time.  ``cap_slack > 0`` relaxes ESD's per-worker
capacity past m (feasible under the ragged exchange), which strictly
lowers the Alg.-1 objective (``SimResult.alg1_cost``) under skew.
``exchange=None`` (default) keeps the pre-exchange accounting bitwise.

The port: the host-side numpy is the JAX package's, line for line, so
both packages give the same results from one seed.  ``SimConfig.device``
(``"cuda"`` unless the caller asks for the CPU; resolved once when
:func:`simulate` starts, raising without a card) is where
``opt="auction"`` runs: the eps-scaled auction, each decision one launch
of the CUDA kernel :func:`repro_torch.kernels.auction.auction_solve`.

Faults (``SimConfig.faults``, a :class:`repro_torch.elastic.FaultPlan`):
each iteration applies the plan's crash and rejoin events to the cache
engine (a graceful crash flushes its dirty rows and hands its clean
inventory to the survivors; a warm rejoin is seeded by its peers), runs
the dispatch on the step's effective link times with the straggler and
dead-worker cost bias and the capacity the survivors need, and prices
the flush and handoff traffic, the straggler's compute and the dead
workers' silence into the iteration's time; ``SimResult.elastic``
counts it.  An empty plan gives the static cluster's results bit for
bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np

from ..data.synthetic import CTRWorkload
from ..device import resolve_device
from ..exchange.plan import compile_plan
from ..obs.metrics import MetricsRegistry
from ..ps import make_partition
from .baselines import (FAECache, HETCache, laia_dispatch, random_dispatch,
                        random_dispatch_active)
from .cache import ClusterCache, EvictPlan, IterStats, SparseClusterCache
from .cost import (batch_unique_np, cost_from_state_cols,
                   cost_from_state_cols_ps, cost_matrix_np,
                   transmission_time, transmission_time_codec)
from .hybrid import hybrid_dispatch

__all__ = ["SimConfig", "SimResult", "simulate", "GBPS",
           "DEFAULT_BANDWIDTHS", "hetero_ps_bandwidths",
           "exchange_worker_times", "calibrated_decision_time"]

GBPS = 1e9 / 8  # bytes per second per Gbps


def DEFAULT_BANDWIDTHS(n: int) -> np.ndarray:
    """Paper default: half the workers on 5 Gbps, half on 0.5 Gbps."""
    return np.array([5.0 * GBPS] * (n // 2) + [0.5 * GBPS] * (n - n // 2))


def hetero_ps_bandwidths(n: int, n_ps: int, fast_gbps: float = 5.0,
                         slow_gbps: float = 0.5) -> np.ndarray:
    """Heterogeneous-PS preset: every worker reaches the last PS over a
    slow link and the rest over fast links — (n, n_ps) bytes/s.  The
    skewed-links scenario where cost-aware dispatch should shine: ids
    homed on the slow shard are 10x more expensive to miss."""
    bw = np.full((n, n_ps), fast_gbps * GBPS)
    bw[:, -1] = slow_gbps * GBPS
    return bw


def exchange_worker_times(link_bytes: np.ndarray,
                          bw: np.ndarray) -> np.ndarray:
    """(n,) per-worker wall time of one sample-exchange step.

    ``link_bytes[i, j]`` = wire bytes on the ordered (src, dst) link;
    each link is priced at the slower end's bandwidth (a transfer cannot
    outrun either NIC), a worker serializes its own sends and receives,
    and the self-link (i == j) is a local copy that costs no wire time.
    """
    bw = np.asarray(bw, np.float64)
    link_t = np.asarray(link_bytes, np.float64) / np.minimum(
        bw[:, None], bw[None, :])
    np.fill_diagonal(link_t, 0.0)
    return link_t.sum(axis=1) + link_t.sum(axis=0)


@dataclasses.dataclass
class SimConfig:
    workload: CTRWorkload
    n_workers: int = 8
    batch_per_worker: int = 128          # m
    cache_ratio: float = 0.08            # r
    embedding_dim: int = 512             # paper default embedding size
    bandwidths: np.ndarray | None = None # (n,) bytes/s
    policy: str = "emark"
    iters: int = 60
    warmup: int = 10                     # paper excludes first 10 iters
    seed: int = 0
    compute_time_s: float = 0.010        # fwd+bwd+allreduce per iteration
    mechanism: str = "esd"               # esd | laia | het | fae | random
    alpha: float = 1.0                   # ESD alpha
    opt: Literal["hungarian", "auction", "ssp"] = "ssp"
    hybrid_variant: str = "paper"        # or "opt_first" (beyond-paper)
    het_staleness: int = 0               # BSP default: staleness tolerance off
    decision_model: Literal["measured", "calibrated"] = "calibrated"
    engine: Literal["sparse", "dense"] = "sparse"   # cost/cache engine
    # multi-PS: partition the V-space over n_ps parameter servers; links
    # become per-(worker, shard).  ps_bandwidths (n, n_ps) bytes/s — None
    # with n_ps > 1 means every shard shares the worker's default link.
    n_ps: int = 1
    ps_layout: Literal["contiguous", "hashed"] = "contiguous"
    ps_bandwidths: np.ndarray | None = None
    # sample-exchange accounting: charge the dispatch's worker-to-worker
    # sample movement at planned bytes ("ragged") or at the fixed-shape
    # baseline's uniform blocks ("padded"); None = not modeled (bitwise
    # pre-exchange behavior).  cap_slack relaxes ESD's per-worker
    # capacity by that fraction of m (needs exchange="ragged").
    exchange: Literal["padded", "ragged"] | None = None
    cap_slack: float = 0.0
    # dispatch pipelining: depth >= 2 (default, the paper's setup) hides
    # the decision for t+1 under iteration t, so the stages take the max;
    # depth == 1 is the synchronous loop (stages sum).  lookahead = W > 0
    # additionally runs a W-batch dedup window over the stream whose
    # touched ids shield soon-reused cache entries from eviction
    # (repro.pipeline.window); W = 0 keeps the cache bitwise.
    pipeline_depth: int = 2
    lookahead: int = 0
    # window-driven prefetch timing (needs lookahead > 0): misses whose
    # ids the previous step's eviction plan announced count as
    # *prefetched* — their pull overlaps training in a prefetch stage —
    # while first-seen (demand) misses stay on the critical path.  False
    # keeps the timing model bitwise (the miss split is still reported).
    prefetch: bool = False
    # fault injection (repro_torch.elastic.FaultPlan): scripted/stochastic
    # worker crash/rejoin, straggler slowdown, bandwidth droop, PS-shard
    # outage.  None (default) is the unchanged static-cluster path; an
    # *empty* plan runs the elastic code path with neutral values and is
    # bitwise-equal to None (pinned in tests).
    faults: "object | None" = None
    # quantized wire (repro_torch.quant): codec for the embedding-row
    # transmissions (PS miss pulls / update+evict pushes) — folds the
    # per-link byte width into Alg.-1's T_j, so dispatch decisions shift
    # toward links whose codec makes them cheap.  codec_policy
    # "bandwidth" splits at the median link speed (fast links fp16,
    # slow ones the codec / int4).  codec=None with policy "uniform"
    # (the defaults) is the bitwise fp32 path.
    codec: str | None = None
    codec_policy: Literal["uniform", "bandwidth"] = "uniform"
    # serving mode (repro_torch.serve): a ServeKnobs here switches simulate()
    # to the request path — micro-batched Poisson/flash-crowd arrivals
    # dispatched with the latency-SLO cost against read-only TTL cache
    # planes, returning a ServeResult (p50/p99 latency, SLO-violation
    # rate, QPS per worker) instead of a SimResult.  mechanism must be
    # "esd" or "random"; the shared fields (workload, n_workers,
    # bandwidths, embedding_dim, cache_ratio, alpha, seed, n_ps, codec)
    # mean the same thing they do for training.
    serve: "object | None" = None
    # where opt="auction" runs; "cuda" raises without a card
    device: str = "cuda"

    @property
    def d_tran(self) -> float:
        return self.embedding_dim * 4.0  # fp32 bytes per embedding vector

    @property
    def k(self) -> int:
        return self.n_workers * self.batch_per_worker


# Paper Table 2: CUDA-parallel Hungarian latency (ms) by batch-per-worker.
# Used by the "calibrated" decision model: we simulate the paper's testbed
# (edge workers with GPUs), whose dispatch latency is NOT this container's
# 1-CPU-core solver wall time (reported separately in benchmarks/table2).
_TABLE2_PARALLEL_MS = {32: 21, 64: 28, 128: 82, 256: 186, 512: 811, 1024: 1385}


def calibrated_decision_time(bpw: int, alpha: float) -> float:
    """Seconds; Opt part interpolated from paper Table 2 at bpw*alpha."""
    if alpha <= 0:
        return 1e-3
    eff = max(32.0, bpw * alpha)
    xs = sorted(_TABLE2_PARALLEL_MS)
    ys = [_TABLE2_PARALLEL_MS[x] for x in xs]
    ms = float(np.interp(eff, xs, ys))
    return ms * 1e-3 + 1e-3


@dataclasses.dataclass
class SimResult:
    cost: float                       # total transmission cost [s], post-warmup
    itps: float
    hit_ratio: float
    decision_time_mean: float
    ingredient: dict                  # {bandwidth_class: {op: count}}
    per_iter_cost: np.ndarray
    per_iter_time: np.ndarray
    # Alg.-1 objective of the chosen assignments (esd only), post-warmup
    alg1_cost: float | None = None
    # sample-exchange byte/time accounting (SimConfig.exchange set)
    exchange: dict | None = None
    # stage breakdown + lookahead-window dedup accounting (always set)
    pipeline: dict | None = None
    # fault/churn accounting (SimConfig.faults set): events applied, flush
    # pushes, handoff rows/time, worst-case surviving worker count
    elastic: dict | None = None
    # quantized-wire accounting (SimConfig.codec / codec_policy set):
    # per-link codec census + embedding fp32-vs-wire byte totals
    quant: dict | None = None
    # namespaced registry snapshot (repro_torch.obs.metrics) — the same
    # quantities the fields above are reduced from, under the unified
    # metric names (cache.hits, exchange.wire_bytes, elastic.min_active,
    # ...).  The legacy fields stay the canonical API; this is the view
    # the observability layer reads.
    metrics: dict | None = None

    def summary(self) -> dict:
        out = {
            "cost": self.cost,
            "itps": self.itps,
            "hit_ratio": self.hit_ratio,
            "decision_ms": self.decision_time_mean * 1e3,
        }
        if self.alg1_cost is not None:
            out["alg1_cost"] = self.alg1_cost
        if self.exchange is not None:
            out["exchange"] = self.exchange
        if self.elastic is not None:
            out["elastic"] = self.elastic
        if self.quant is not None:
            out["quant"] = self.quant
        if self.pipeline is not None and (
                self.pipeline["depth"] == 1 or self.pipeline["lookahead"]):
            out["pipeline"] = self.pipeline
        return out


def _make_cache(cfg: SimConfig, hot_ids: np.ndarray, vocab: int | None = None,
                part=None):
    cap = int(cfg.cache_ratio * cfg.workload.vocab)
    vocab = cfg.workload.vocab if vocab is None else vocab
    cls = SparseClusterCache if cfg.engine == "sparse" else ClusterCache
    if cfg.mechanism == "het":
        if cfg.het_staleness <= 0:
            # HET under BSP (the paper's setup): version-tracked cache with
            # eager full-set sync -- no staleness advantage available.
            return cls(cfg.n_workers, vocab, cap,
                       policy="lru", sync="eager", part=part)
        return HETCache(cfg.n_workers, vocab, cap,
                        policy="lru", staleness=cfg.het_staleness, part=part)
    if cfg.mechanism == "fae":
        return FAECache(cfg.n_workers, vocab, cap, hot_ids, part=part)
    return cls(cfg.n_workers, vocab, cap, policy=cfg.policy, part=part)


def _worker_batches(samples: np.ndarray, assign: np.ndarray, n: int,
                    vocab: int) -> list[np.ndarray]:
    """Per-worker unique needed ids in one vectorized pass (no per-worker
    python ``np.unique`` loop): sort (worker, id) pairs once and split."""
    F = samples.shape[1]
    ids = samples.ravel()
    owner = np.repeat(assign, F)
    valid = ids >= 0
    key = owner[valid].astype(np.int64) * vocab + ids[valid]
    uniq = np.unique(key)
    splits = np.searchsorted(uniq, np.arange(1, n) * vocab)
    return [part % vocab for part in np.split(uniq, splits)]


def simulate(cfg: SimConfig,
             registry: MetricsRegistry | None = None) -> SimResult:
    # All accumulators live in a metrics registry under the unified
    # namespace (cache.*, exchange.*, dispatch.*, elastic.*, sim.*);
    # SimResult fields are reduced from it with the exact numpy
    # expressions the old bare-list accumulators used, so results are
    # bitwise-unchanged.  Pass a registry to read the metrics after the
    # run (each call wants a fresh one — counters are cumulative).
    resolve_device(cfg.device)
    if cfg.serve is not None:
        from ..serve.sim import simulate_serve
        return simulate_serve(cfg, registry)
    reg = registry if registry is not None else MetricsRegistry()
    n, m, k = cfg.n_workers, cfg.batch_per_worker, cfg.k
    bw = cfg.bandwidths if cfg.bandwidths is not None else DEFAULT_BANDWIDTHS(n)
    t_tran = transmission_time(cfg.d_tran, bw)
    link_codecs = None
    if cfg.codec is not None or cfg.codec_policy != "uniform":
        from ..quant.codecs import resolve_link_codecs
        link_codecs = resolve_link_codecs(cfg.codec_policy, bw, cfg.codec)
        if link_codecs is not None:
            # quantized links re-price T_j (payload + scale/zp metadata)
            # — this is where dispatch decisions change
            t_tran = transmission_time_codec(cfg.embedding_dim, bw,
                                             link_codecs)
    rng = np.random.default_rng(cfg.seed)
    if cfg.cap_slack > 0.0 and cfg.exchange != "ragged":
        raise ValueError("cap_slack > 0 needs exchange='ragged' (the padded "
                         "all_to_all requires equal groups)")
    # ESD per-worker capacity: the hard m cap, relaxed by cap_slack
    esd_cap = min(k, int(np.ceil(m * (1.0 + cfg.cap_slack))))

    # multi-PS: partition the V-space, run caches/ids in the PS-linearized
    # space, and charge ops at the owning shard's link
    use_ps = cfg.n_ps > 1 or cfg.ps_bandwidths is not None
    part = t_ps = None
    vocab = cfg.workload.vocab
    if use_ps:
        part = make_partition(cfg.workload.vocab, cfg.n_ps, cfg.ps_layout)
        bw_ps = (np.asarray(cfg.ps_bandwidths, np.float64)
                 if cfg.ps_bandwidths is not None
                 else np.repeat(np.asarray(bw, np.float64)[:, None],
                                part.n_ps, axis=1))
        if bw_ps.shape != (n, part.n_ps):
            raise ValueError(f"ps_bandwidths shape {bw_ps.shape} != "
                             f"({n}, {part.n_ps})")
        t_ps = transmission_time(cfg.d_tran, bw_ps)        # (n, n_ps)
        if link_codecs is not None:
            from ..quant.codecs import resolve_link_codecs
            # per-(worker, PS) codecs follow the per-shard link speeds
            link_codecs = resolve_link_codecs(cfg.codec_policy, bw_ps,
                                              cfg.codec)
            t_ps = transmission_time_codec(cfg.embedding_dim, bw_ps,
                                           link_codecs)
        vocab = part.linear_size

    # offline popularity profile (for FAE's static hot set) — only FAE
    # reads it, and the bincount/argsort are vocab-bound work the other
    # mechanisms (esd at V >= 2e7 especially) must not pay
    hot_ids = None
    if cfg.mechanism == "fae":
        profile = cfg.workload.sample_batch(
            np.random.default_rng(123), 20_000).ravel()
        profile = profile[profile >= 0]
        hot_ids = np.argsort(-np.bincount(profile, minlength=cfg.workload.vocab))
        if use_ps:
            # FAE's hot set lives in the same PS-linearized space as ids
            hot_ids = part.to_linear(hot_ids)

    if cfg.pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got "
                         f"{cfg.pipeline_depth}")
    if cfg.prefetch and cfg.lookahead <= 0:
        raise ValueError("prefetch timing needs lookahead > 0 (the window "
                         "plan is what announces future misses)")
    if cfg.prefetch and cfg.faults is not None:
        raise ValueError("prefetch timing under a fault plan is not "
                         "modeled")
    cache = _make_cache(cfg, hot_ids, vocab=vocab, part=part)

    faults = cfg.faults
    elastic_acc = None
    if faults is not None:
        from ..elastic import (cost_column_bias, departure_handoff,
                               effective_t, rejoin_handoff)
        if faults.n_workers != n:
            raise ValueError(f"FaultPlan is for {faults.n_workers} workers, "
                             f"simulating {n}")
        if faults.n_ps > 1 and (part is None or faults.n_ps != part.n_ps):
            raise ValueError(f"FaultPlan targets {faults.n_ps} PS shards, "
                             f"simulating {1 if part is None else part.n_ps}")
        churn = any(e.kind in ("crash", "rejoin") for e in faults.events)
        if churn and not hasattr(cache, "crash"):
            raise ValueError(f"mechanism {cfg.mechanism!r}'s cache model "
                             "does not support membership churn")
        elastic_acc = {"events": [e.to_dict() for e in faults.events
                                  if e.step < cfg.iters],
                       "flush_push_ops": reg.counter("elastic.flush_push_ops"),
                       "handoff_rows": reg.counter("elastic.handoff_rows"),
                       "handoff_time_s": reg.counter("elastic.handoff_time_s"),
                       "min_active": reg.gauge("elastic.min_active")}
        elastic_acc["min_active"].set(n)

    stream = cfg.workload.stream(cfg.seed + 1, k)
    if cfg.lookahead > 0:
        from ..pipeline.window import LookaheadWindow
        stream = LookaheadWindow(stream, cfg.lookahead, key=lambda b: b[0])

    # kept histograms retain every sample so the post-loop reductions can
    # reuse the original numpy expressions verbatim
    h_cost = reg.histogram("sim.iter_cost_s", keep=True)
    h_time = reg.histogram("sim.iter_time_s", keep=True)
    h_dec = reg.histogram("dispatch.decision_s", keep=True)
    h_alg1 = reg.histogram("dispatch.alg1_cost", keep=True)
    h_train = reg.histogram("sim.train_stage_s", keep=True)
    c_dedup_saved = reg.counter("prefetch.window_dedup_saved")
    c_dedup_touch = reg.counter("prefetch.window_touches")
    c_pre = reg.counter("cache.miss_prefetched")
    c_dem = reg.counter("cache.demand_miss")
    c_hits = reg.counter("cache.hits")
    c_lookups = reg.counter("cache.lookups")
    split_seen = False
    exch_acc = None
    if cfg.exchange is not None:
        exch_acc = {"mode": cfg.exchange,
                    "payload_bytes": reg.counter("exchange.payload_bytes"),
                    "wire_bytes": reg.counter("exchange.wire_bytes"),
                    "padded_wire_bytes":
                        reg.counter("exchange.padded_wire_bytes"),
                    "times": reg.histogram("exchange.time_s", keep=True)}
    quant_acc = None
    if link_codecs is not None:
        from ..quant.codecs import meta_row_bytes, wire_row_bytes
        E = cfg.embedding_dim
        # precompute per-link byte widths once; every embedding op on a
        # link moves one E-row at its codec's width
        _wire_b = np.vectorize(
            lambda c: wire_row_bytes(E, c), otypes=[np.int64])(link_codecs)
        _meta_b = np.vectorize(
            lambda c: meta_row_bytes(E, c), otypes=[np.int64])(link_codecs)
        quant_acc = {"ops": np.zeros(link_codecs.shape, np.int64)}
    ingredient = {
        cls: {op: reg.counter(f"cache.{cls}.{op}")
              for op in ("miss_pull", "update_push", "evict_push")}
        for cls in ("5Gbps", "0.5Gbps")
    }
    fast = bw >= np.median(bw)

    for it in range(cfg.iters):
        protect = None
        if cfg.lookahead > 0:
            (samples, _, _), wmeta = next(stream)
            # exact eviction plan from the window oracle: no-pending-use
            # candidates evict first, then in-window rows by farthest
            # next use (Belady on the W-step horizon)
            protect = EvictPlan.from_window(wmeta)
            if use_ps:
                protect = protect.linearize(part)  # hashed layouts unsort
            if it >= cfg.warmup:
                c_dedup_saved.inc(wmeta.dedup_saved)
                c_dedup_touch.inc(wmeta.total_touches)
        else:
            samples, _, _ = next(stream)
        if use_ps:
            samples = part.to_linear(samples)

        # elastic: apply this step's membership transitions to the cache,
        # derive the step's effective link times / bandwidths, and price
        # the flush + handoff traffic the transitions imply
        cs = None
        t_it, tps_it, bw_it, handoff_t = t_tran, t_ps, bw, 0.0
        if faults is not None:
            cs = faults.state_at(it)
            elastic_acc["min_active"].set(
                min(elastic_acc["min_active"].value, cs.n_active))
            bw_it = bw * cs.bw_factor
            if use_ps:
                tps_it = effective_t(t_ps, cs)
            else:
                t_it = effective_t(t_tran, cs)
            for ev in faults.events_at(it):
                if ev.kind == "crash":
                    res = cache.crash(ev.target, graceful=ev.graceful)
                    flushed = len(res["flushed"])
                    if flushed:
                        # the leaver drains its dirty rows to the PS over
                        # its own link (per-PS: shards in parallel)
                        elastic_acc["flush_push_ops"].inc(flushed)
                        if use_ps:
                            handoff_t += float(
                                (res["flushed_ps"] * tps_it[ev.target]).max())
                        else:
                            handoff_t += flushed * float(t_it[ev.target])
                    if ev.graceful and len(res["inventory"]):
                        hp = departure_handoff(cache, ev.target,
                                               res["inventory"], cs.active,
                                               row_bytes=cfg.d_tran)
                    else:
                        hp = None
                else:  # rejoin
                    hp = (rejoin_handoff(cache, ev.target, cs.active,
                                         row_bytes=cfg.d_tran)
                          if ev.warm else None)
                if hp is not None and hp.rows:
                    hp_t = float(exchange_worker_times(hp.link_bytes(),
                                                       bw_it).max())
                    handoff_t += hp_t
                    elastic_acc["handoff_rows"].inc(hp.rows)
                    elastic_acc["handoff_time_s"].inc(hp_t)

        t0 = time.perf_counter()
        alg1 = None
        if cfg.mechanism == "esd":
            if use_ps:
                # per-shard link costs: gather state columns at the unique
                # (linearized) ids and weight by the owning PS's t
                ids_, mask, uids, inv = batch_unique_np(samples)
                latU, dirU = cache.state_columns(uids)
                C = cost_from_state_cols_ps(inv, mask, latU, dirU, tps_it,
                                            part.shard_of_linear(uids))
            elif cfg.engine == "sparse":
                # touched-ids Alg. 1: gather state columns for the batch's
                # unique ids only — no dense snapshot, no O(n*V) work
                ids_, mask, uids, inv = batch_unique_np(samples)
                latU, dirU = cache.state_columns(uids)
                C = cost_from_state_cols(inv, mask, latU, dirU, t_it)
            else:
                latest, dirty = cache.snapshot()
                C = cost_matrix_np(samples, latest, dirty, t_it)
            cap_it = esd_cap
            if faults is not None:
                # straggler excess compute + finite dead-worker penalty on
                # the cost columns; capacity raised so the survivors can
                # absorb every sample (neutral state: bias is exactly 0.0
                # and cap_it == esd_cap — the bitwise-pinned path)
                bias = cost_column_bias(tps_it if use_ps else t_it,
                                        samples.shape[1], cs.active,
                                        cs.compute_factor, cfg.compute_time_s)
                C = C + bias[None, :].astype(C.dtype)
                cap_it = max(esd_cap, -(-k // cs.n_active))
            assign = hybrid_dispatch(C, cap_it, cfg.alpha, opt=cfg.opt,
                                     variant=cfg.hybrid_variant,
                                     device=cfg.device)
            alg1 = float(C[np.arange(k), assign].sum())
        elif cfg.mechanism == "laia":
            if faults is None:
                assign = laia_dispatch(samples, cache.latest_in_cache, m)
            else:
                assign = laia_dispatch(samples, cache.latest_in_cache,
                                       max(m, -(-k // cs.n_active)),
                                       active=cs.active)
        else:  # het / fae / random all use random dispatch
            assign = (random_dispatch(k, n, rng) if faults is None
                      else random_dispatch_active(k, cs.active, rng))
        dec_t = time.perf_counter() - t0
        if cfg.decision_model == "calibrated":
            dec_t = (calibrated_decision_time(m, cfg.alpha)
                     if cfg.mechanism == "esd" else 1e-3)

        batches = _worker_batches(samples, assign, n, vocab)
        stats: IterStats = cache.step(batches, protect=protect)

        if use_ps:
            # cost = total traffic over every (worker, PS) link; a worker's
            # wall time is its slowest link (shards transfer in parallel)
            cost = stats.cost_ps(tps_it)
            comm = stats.per_worker_time_ps(tps_it)
        else:
            cost = stats.cost(t_it)
            comm = stats.per_worker_cost(t_it)

        # prefetch timing: announced-miss pulls ran in a prefetch stage
        # overlapped with the previous train step, so only demand misses
        # keep their wire time on the training critical path (total cost
        # is unchanged — the bytes still move, just earlier)
        pre_t = 0.0
        if cfg.prefetch and stats.miss_prefetched is not None:
            if use_ps:
                pre_ops = np.asarray(stats.miss_prefetched_ps, np.float64)
                pre_t = float((pre_ops * tps_it).max(axis=1).max())
                comm = ((stats._ops_ps() - pre_ops) * tps_it).max(axis=1)
            else:
                pre = np.asarray(stats.miss_prefetched, np.float64)
                pre_t = float((pre * t_it).max())
                comm = comm - pre * t_it

        # sample-exchange time from the compiled plan's byte accounting:
        # ragged ships the bucketed schedule, padded one uniform block.
        # Each (src, dst) link is priced at min(bw_src, bw_dst) — a
        # transfer cannot outrun either end's NIC — a worker serializes
        # its own sends + receives, and the self-link is a free local
        # copy (it never crosses the wire).
        exch_t = 0.0
        if cfg.exchange is not None:
            t_plan0 = time.perf_counter()
            plan = compile_plan(assign, n, m,
                                row_bytes=samples.shape[1] * 4, cap=m,
                                active=None if cs is None else cs.active)
            plan_t = time.perf_counter() - t_plan0
            if cfg.decision_model == "measured":
                # plan compilation is part of the decision stage (it is
                # host-side work the pipeline hides the same way)
                dec_t += plan_t
            rows_link = (plan.buckets if cfg.exchange == "ragged"
                         else np.full((n, n), plan.padded_block, np.int64))
            if cs is not None and not cs.active.all():
                # no blocks move toward dead destinations (the ragged
                # buckets are already zero there; the padded baseline
                # re-bases on the surviving columns)
                rows_link = rows_link * cs.active[None, :]
            link_bytes = rows_link * plan.row_bytes
            exch_t = float(exchange_worker_times(link_bytes, bw_it).max())
            if it >= cfg.warmup:
                exch_acc["payload_bytes"].inc(plan.stats.payload_bytes)
                exch_acc["wire_bytes"].inc(int(link_bytes.sum()))
                exch_acc["padded_wire_bytes"].inc(plan.stats.padded_bytes)
                exch_acc["times"].observe(exch_t)
        # two pipeline stages: training (compute + PS sync + sample
        # exchange) and the dispatch decision (+ plan) for the next
        # iteration.  Pipelined they overlap (max); synchronous they sum.
        if faults is None:
            train_stage = cfg.compute_time_s + comm.max() + exch_t
        else:
            # per-worker compute priced at the straggler factor; dead
            # workers contribute nothing; flush/handoff traffic extends
            # the step it happens in.  Neutral state: factor 1.0 and the
            # max over (c + comm_j) equal the static formula bitwise.
            per_w = cfg.compute_time_s * cs.compute_factor + comm
            train_stage = (float(np.where(cs.active, per_w, 0.0).max())
                           + exch_t + handoff_t)
        if cfg.pipeline_depth >= 2:
            iter_time = max(train_stage, dec_t, pre_t)
        else:
            iter_time = train_stage + dec_t + pre_t

        if it >= cfg.warmup:
            h_cost.observe(cost)
            h_time.observe(iter_time)
            h_train.observe(train_stage)
            h_dec.observe(dec_t)
            if alg1 is not None:
                h_alg1.observe(alg1)
            c_hits.inc(int(stats.hits.sum()))
            c_lookups.inc(int(stats.lookups.sum()))
            if stats.miss_prefetched is not None:
                # baseline caches (HET/FAE) build their own IterStats and
                # report no split — guard, don't fake zeros
                split_seen = True
                c_pre.inc(int(stats.miss_prefetched.sum()))
                c_dem.inc(int(stats.miss_demand.sum()))
            for cls, mask in (("5Gbps", fast), ("0.5Gbps", ~fast)):
                ingredient[cls]["miss_pull"].inc(int(stats.miss_pull[mask].sum()))
                ingredient[cls]["update_push"].inc(int(stats.update_push[mask].sum()))
                ingredient[cls]["evict_push"].inc(int(stats.evict_push[mask].sum()))
            if quant_acc is not None:
                if link_codecs.ndim == 2:
                    ops = (np.asarray(stats.miss_pull_ps)
                           + np.asarray(stats.update_push_ps)
                           + np.asarray(stats.evict_push_ps))
                else:
                    ops = (np.asarray(stats.miss_pull)
                           + np.asarray(stats.update_push)
                           + np.asarray(stats.evict_push))
                quant_acc["ops"] += ops.astype(np.int64)

    per_iter_cost = np.asarray(h_cost.samples)
    per_iter_time = np.asarray(h_time.samples)
    dec_times = h_dec.samples
    exchange = None
    if exch_acc is not None:
        payload_b = exch_acc["payload_bytes"].value
        wire_b = exch_acc["wire_bytes"].value
        padded_b = exch_acc["padded_wire_bytes"].value
        pad = wire_b - payload_b
        pad_base = padded_b - payload_b
        exchange = {
            "mode": exch_acc["mode"],
            "payload_bytes": payload_b,
            "wire_bytes": wire_b,
            "padded_wire_bytes": padded_b,
            "pad_bytes": pad,
            "pad_reduction": ((1.0 - pad / pad_base) if pad_base
                              else (1.0 if pad == 0 else 0.0)),
            "time_mean_s": float(np.mean(exch_acc["times"].samples))
            if exch_acc["times"].samples else 0.0,
        }
    quant = None
    if quant_acc is not None:
        from ..quant.codecs import codec_name
        ops = quant_acc["ops"]
        fp32_b = int(ops.sum()) * int(cfg.d_tran)
        wire_b = int((ops * _wire_b).sum())
        meta_b = int((ops * _meta_b).sum())
        reg.counter("quant.emb_fp32_bytes").inc(fp32_b)
        reg.counter("quant.emb_wire_bytes").inc(wire_b)
        reg.counter("quant.emb_meta_bytes").inc(meta_b)
        names, cnts = np.unique(link_codecs.astype(str), return_counts=True)
        quant = {
            "codec": codec_name(cfg.codec),
            "policy": cfg.codec_policy,
            "link_codecs": {str(nm): int(c) for nm, c in zip(names, cnts)},
            "emb_fp32_bytes": fp32_b,
            "emb_wire_bytes": wire_b,
            "emb_meta_bytes": meta_b,
            "byte_reduction": (fp32_b / wire_b) if wire_b else None,
        }
    # legacy plain-int ingredient dict, reduced from the counters
    ingredient = {cls: {op: c.value for op, c in ops_.items()}
                  for cls, ops_ in ingredient.items()}
    pipeline = {
        "depth": cfg.pipeline_depth,
        "lookahead": cfg.lookahead,
        "train_stage_mean_s": (float(np.mean(h_train.samples))
                               if h_train.samples else 0.0),
        "decision_stage_mean_s": (float(np.mean(dec_times))
                                  if dec_times else 0.0),
        "miss_pull_total": int(sum(ingredient[c]["miss_pull"]
                                   for c in ingredient)),
        "dedup_saved_ops": int(c_dedup_saved.value),
        "dedup_total_touches": int(c_dedup_touch.value),
        "prefetch": bool(cfg.prefetch),
    }
    if split_seen:
        pre_total, dem_total = c_pre.value, c_dem.value
        pipeline["miss_prefetched_total"] = pre_total
        pipeline["miss_demand_total"] = dem_total
        pipeline["prefetch_hit_rate"] = pre_total / max(pre_total + dem_total,
                                                        1)
    elastic = None
    if elastic_acc is not None:
        elastic = {"events": elastic_acc["events"],
                   "flush_push_ops": elastic_acc["flush_push_ops"].value,
                   "handoff_rows": elastic_acc["handoff_rows"].value,
                   "handoff_time_s": elastic_acc["handoff_time_s"].value,
                   "min_active": elastic_acc["min_active"].value}
    return SimResult(
        cost=float(per_iter_cost.sum()),
        itps=float(len(per_iter_time) / per_iter_time.sum()),
        hit_ratio=c_hits.value / max(c_lookups.value, 1),
        decision_time_mean=float(np.mean(dec_times)),
        ingredient=ingredient,
        per_iter_cost=per_iter_cost,
        per_iter_time=per_iter_time,
        alg1_cost=float(np.sum(h_alg1.samples)) if h_alg1.samples else None,
        exchange=exchange,
        pipeline=pipeline,
        elastic=elastic,
        quant=quant,
        metrics=reg.snapshot(),
    )
