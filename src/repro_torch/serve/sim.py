"""Virtual-clock serving simulator: p50/p99 latency under QPS, SLO, TTL.

The serving twin of :func:`repro_torch.core.simulator.simulate` — reached via
``SimConfig.serve = ServeKnobs(...)`` — replays a seeded Poisson /
flash-crowd request stream (:mod:`.stream`) against n edge workers that
each hold a read-only replicated hot-cache plane, dispatching every
micro-batch with the latency-SLO cost (:mod:`.cost`, mechanism
``"esd"``) or uniformly at random (``"random"``), and accounts
per-request completion latency on a virtual clock:

    done_j = max(now, busy_until_j) + pull + ttl_refresh + service

* ``pull``: miss rows × the per-(worker, PS) link time (codec-priced,
  same ``transmission_time_codec`` as training dispatch) — a request
  whose ids the worker's plane lacks pays the PS round-trip on the
  critical path;
* ``ttl_refresh``: plane rows the batch touches whose age exceeds the
  TTL re-pull first (read-your-refresh), their ages sampled into the
  ``serve.staleness_s`` histogram;
* ``service``: dense-forward time, constant + per-request marginal.

All quantities flow through an obs registry (``serve.latency_s`` and
``serve.staleness_s`` kept histograms, counters for requests / SLO
violations / pull + refresh rows); p50/p99 are
:meth:`repro_torch.obs.metrics.Histogram.quantile` over the kept
samples.  Everything is deterministic given the seed.

The port: the numpy is the JAX package's, line for line, so both
packages give the same results from one seed.  ``cfg.device`` is where
``opt="auction"`` runs (``"cuda"`` unless the caller asks for the CPU;
raising without a card).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve_device
from ..obs.metrics import MetricsRegistry
from ..quant.codecs import resolve_link_codecs
from .cost import serve_cost_matrix, serve_decide
from .stream import StreamConfig, micro_batches, request_arrivals

__all__ = ["ServeKnobs", "ServeResult", "simulate_serve"]


@dataclasses.dataclass(frozen=True)
class ServeKnobs:
    """Serving-mode knobs riding on a ``SimConfig`` (``cfg.serve``); the
    shared fields — workload, n_workers, bandwidths, embedding_dim,
    cache_ratio, mechanism, alpha, seed, n_ps/ps_*, codec — come from
    the SimConfig itself."""

    qps: float = 2000.0
    duration_s: float = 2.0
    slo_ms: float = 25.0
    max_batch: int = 32
    max_wait_ms: float = 2.0
    ttl_s: float = 0.5              # plane-row freshness deadline
    service_ms: float = 1.0         # dense forward, per micro-batch floor
    service_us_per_req: float = 40.0
    slo_penalty: float = 4.0
    cap_factor: float = 2.0         # per-batch per-worker capacity slack
    warm_requests: int = 2048       # stream head used to pick the hot set
    # flash crowd + Zipf drift (see serve.stream)
    burst_at_s: float | None = None
    burst_dur_s: float = 0.0
    burst_x: float = 1.0
    drift_period_s: float | None = None


@dataclasses.dataclass
class ServeResult:
    p50_s: float
    p99_s: float
    mean_s: float
    slo_violation_rate: float
    qps_per_worker: np.ndarray       # (n,) served requests / duration
    n_requests: int
    n_batches: int
    pull_rows: int                   # demand miss pulls (critical path)
    refresh_rows: int                # TTL refresh pulls
    staleness_p99_s: float           # age of served plane rows
    mechanism: str = "esd"
    metrics: dict | None = None      # obs registry snapshot

    def summary(self) -> dict:
        return {
            "mechanism": self.mechanism,
            "p50_ms": self.p50_s * 1e3,
            "p99_ms": self.p99_s * 1e3,
            "mean_ms": self.mean_s * 1e3,
            "slo_violation_rate": self.slo_violation_rate,
            "qps_per_worker": [float(q) for q in self.qps_per_worker],
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "pull_rows": self.pull_rows,
            "refresh_rows": self.refresh_rows,
            "staleness_p99_s": self.staleness_p99_s,
        }


def _hot_set(workload, rng: np.random.Generator, warm: int,
             cap: int) -> np.ndarray:
    """The ``cap`` most frequent ids of a ``warm``-request stream head —
    what every worker's read-only plane replicates."""
    sample = workload.sample_batch(rng, warm)
    ids = sample[sample >= 0]
    uniq, cnt = np.unique(ids, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    return np.sort(uniq[order[:cap]])


def simulate_serve(cfg, registry: MetricsRegistry | None = None
                   ) -> ServeResult:
    """Run the serving episode described by ``cfg`` (a
    :class:`repro_torch.core.simulator.SimConfig` with ``cfg.serve``
    set)."""
    from ..core.simulator import DEFAULT_BANDWIDTHS
    from ..core.cost import transmission_time_codec

    resolve_device(cfg.device)
    knobs: ServeKnobs = cfg.serve
    if knobs is None:
        raise ValueError("simulate_serve needs cfg.serve = ServeKnobs(...)")
    if cfg.mechanism not in ("esd", "random"):
        raise ValueError(f"serve mechanism must be esd|random, "
                         f"got {cfg.mechanism!r}")
    reg = registry if registry is not None else MetricsRegistry()
    wl = cfg.workload
    n = cfg.n_workers
    V = wl.vocab
    E = cfg.embedding_dim
    slo_s = knobs.slo_ms * 1e-3

    part = None
    if cfg.n_ps > 1:
        from ..ps import make_partition
        part = make_partition(V, cfg.n_ps, cfg.ps_layout)
        bw = cfg.ps_bandwidths
        if bw is None:
            base = (cfg.bandwidths if cfg.bandwidths is not None
                    else DEFAULT_BANDWIDTHS(n))
            bw = np.broadcast_to(np.asarray(base)[:, None],
                                 (n, cfg.n_ps)).copy()
    else:
        bw = (cfg.bandwidths if cfg.bandwidths is not None
              else DEFAULT_BANDWIDTHS(n))
    bw = np.asarray(bw, np.float64)
    link_codecs = resolve_link_codecs(cfg.codec_policy, bw, cfg.codec) \
        if cfg.codec is not None else None
    t_row = transmission_time_codec(E, bw, link_codecs)  # (n,) or (n, n_ps)

    rng = np.random.default_rng(cfg.seed)
    cap = max(1, int(cfg.cache_ratio * V))
    hot = _hot_set(wl, np.random.default_rng(cfg.seed + 1),
                   knobs.warm_requests, cap)
    resident = np.zeros((n, V), bool)
    resident[:, hot] = True
    pos = np.full(V, -1, np.int64)
    pos[hot] = np.arange(hot.size)
    last_refresh = np.zeros((n, hot.size), np.float64)

    stream = StreamConfig(
        workload=wl, qps=knobs.qps, duration_s=knobs.duration_s,
        seed=cfg.seed, burst_at_s=knobs.burst_at_s,
        burst_dur_s=knobs.burst_dur_s, burst_x=knobs.burst_x,
        drift_period_s=knobs.drift_period_s)
    t_arr, sparse, dense = request_arrivals(stream)
    batches = micro_batches(t_arr, sparse, dense,
                            max_size=knobs.max_batch,
                            max_wait_s=knobs.max_wait_ms * 1e-3)

    lat_h = reg.histogram("serve.latency_s", keep=True)
    stale_h = reg.histogram("serve.staleness_s", keep=True)
    req_c = reg.counter("serve.requests")
    slo_c = reg.counter("serve.slo_violations")
    pull_c = reg.counter("serve.pull_rows")
    refresh_c = reg.counter("serve.refresh_rows")
    batch_c = reg.counter("serve.batches")

    busy_until = np.zeros(n, np.float64)
    served = np.zeros(n, np.int64)
    service_base = knobs.service_ms * 1e-3
    per_req = knobs.service_us_per_req * 1e-6
    marginal = np.full(n, service_base + per_req)
    cap_b = max(1, int(np.ceil(knobs.max_batch / n * knobs.cap_factor)))

    def link_time(j: int, uids: np.ndarray) -> np.ndarray:
        """(U,) per-row wire time on worker j's link(s)."""
        if t_row.ndim == 1:
            return np.full(uids.shape, t_row[j])
        return t_row[j, np.asarray(part.shard_of(uids))]

    for b in batches:
        now = b.t_close
        queue_s = np.maximum(busy_until - now, 0.0)
        slack = (b.t_arrive + slo_s) - now
        if cfg.mechanism == "esd":
            C = serve_cost_matrix(b.sparse, resident, t_row, queue_s,
                                  marginal, slack,
                                  slo_penalty=knobs.slo_penalty, part=part)
            assign = serve_decide(C, cap=cap_b, alpha=cfg.alpha,
                                  opt=cfg.opt, device=cfg.device)
        else:
            assign = rng.integers(0, n, len(b.t_arrive))
        batch_c.inc()
        for j in np.unique(assign[:len(b.t_arrive)][b.valid]):
            rows = b.valid & (assign == j)
            n_j = int(rows.sum())
            ids_j = b.sparse[rows]
            uids = np.unique(ids_j[ids_j >= 0])
            lt = link_time(j, uids) if uids.size else np.zeros(0)
            res_u = resident[j, uids] if uids.size else np.zeros(0, bool)
            pull_t = float(lt[~res_u].sum())
            pull_c.inc(int((~res_u).sum()))
            # TTL: touched plane rows past deadline refresh before serving
            pos_u = pos[uids[res_u]]
            ages = now - last_refresh[j, pos_u]
            for a in ages:
                stale_h.observe(float(a))
            due = ages > knobs.ttl_s
            refresh_t = float(lt[res_u][due].sum())
            refresh_c.inc(int(due.sum()))
            last_refresh[j, pos_u[due]] = now
            start = max(now, busy_until[j])
            done = (start + pull_t + refresh_t + service_base
                    + n_j * per_req)
            busy_until[j] = done
            served[j] += n_j
            for lat in done - b.t_arrive[rows]:
                lat_h.observe(float(lat))
                req_c.inc()
                if lat > slo_s:
                    slo_c.inc()

    dur = max(knobs.duration_s, 1e-9)
    qpw = served / dur
    reg.gauge("serve.qps_per_worker").set([float(q) for q in qpw])
    n_req = req_c.value
    return ServeResult(
        p50_s=lat_h.quantile(0.5),
        p99_s=lat_h.quantile(0.99),
        mean_s=lat_h.mean,
        slo_violation_rate=slo_c.value / n_req if n_req else 0.0,
        qps_per_worker=qpw,
        n_requests=n_req,
        n_batches=batch_c.value,
        pull_rows=pull_c.value,
        refresh_rows=refresh_c.value,
        staleness_p99_s=(stale_h.quantile(0.99) if stale_h.count else 0.0),
        mechanism=cfg.mechanism,
        metrics=reg.snapshot(),
    )
