"""Real-clock online serving driver on PyTorch (CUDA by default).

A seeded Poisson request stream is replayed in real time against n
serve workers (time-shared on one device), each holding a read-only TTL
cache plane seeded with the workload's hot set.  Every micro-batch

  1. waits for its close time (max-wait-or-max-size batcher, paced
     against the process clock),
  2. is dispatched with the latency-SLO ESD cost
     (:func:`repro_torch.serve.cost.serve_cost_matrix` + Alg. 2) or
     uniformly at random (``--mechanism random``),
  3. for each worker that got requests: a TTL refresh of its plane in
     place (:func:`repro_torch.serve.plane.refresh_plane`, one
     ``plane_refresh`` launch; with ``--codec`` the kept rows also go
     through a gather, the codec's round trip, as the quantized wire
     delivers rows, and a ``staged_pull``), then the serve step
     (:func:`repro_torch.serve.step.make_serve_step`, the pooled bag
     through the ``pooled_lookup_staged`` kernel), synchronised so that
     latency means completion; the refresh's count is read after that
     synchronise, so no host wait sits between the refresh and the step.

Latency is wall clock (completion - arrival), reported as p50/p99/mean,
SLO-violation rate, QPS-per-worker and plane staleness age.  Model
weights are random, drawn from ``--seed``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch wdl-s1 \\
      --qps 2000 --duration 1 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch wdl-tiny \\
      --qps 100 --duration 0.3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch wdl-tiny \\
      --qps 100 --duration 0.3 --codec int8 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import DLRM_CONFIGS
from ..core.cost import transmission_time_codec
from ..core.simulator import DEFAULT_BANDWIDTHS
from ..data.synthetic import WORKLOADS
from ..device import resolve_device
from ..models.dlrm import init_params
from ..obs import MetricsRegistry, log_step
from ..pipeline.prefetch import PrefetchPlane
from ..quant.codecs import codec_name, get_codec, resolve_link_codecs
from ..serve import (StreamConfig, make_serve_step, micro_batches,
                     plane_ages, refresh_plane, request_arrivals, seed_plane,
                     serve_cost_matrix, serve_decide)
from ..serve.sim import _hot_set


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wdl-tiny",
                    choices=sorted(DLRM_CONFIGS))
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--duration", type=float, default=2.0,
                    help="stream duration in seconds (real time)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--ttl-batches", type=int, default=32,
                    help="plane-row freshness deadline in micro-batches")
    ap.add_argument("--refresh-budget", type=int, default=64,
                    help="max TTL re-pulls per worker per batch "
                         "(stalest first)")
    ap.add_argument("--cache-ratio", type=float, default=0.25,
                    help="plane capacity as a fraction of the vocab")
    ap.add_argument("--codec", default=None,
                    help="wire codec for plane pulls (none/fp16/int8/int4)")
    ap.add_argument("--codec-policy", choices=("uniform", "bandwidth"),
                    default="uniform")
    ap.add_argument("--mechanism", choices=("esd", "random"), default="esd")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--slo-penalty", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serve(args) -> dict:
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    codec = get_codec(args.codec)
    cfg = DLRM_CONFIGS[args.arch]
    wl = WORKLOADS[cfg.workload]
    n, V, F = args.workers, wl.vocab, wl.n_fields
    slo_s = args.slo_ms * 1e-3
    reg = MetricsRegistry()

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, wl, gen, device)
    table = model.embed

    # replicated hot-set planes, one per worker
    cap = max(1, int(args.cache_ratio * V))
    hot = _hot_set(wl, np.random.default_rng(args.seed + 1), 2048, cap)
    planes = [seed_plane(table, hot, step=0, ttl=args.ttl_batches,
                         codec=codec) for _ in range(n)]
    resident = np.zeros((n, V), bool)
    resident[:, hot] = True

    bw = DEFAULT_BANDWIDTHS(n)
    link_codecs = (resolve_link_codecs(args.codec_policy, bw, codec)
                   if codec is not None else None)
    t_row = transmission_time_codec(cfg.embedding_dim, bw, link_codecs)

    serve_step = make_serve_step(cfg, F)
    t_arr, sparse, dense = request_arrivals(StreamConfig(
        workload=wl, qps=args.qps, duration_s=args.duration,
        seed=args.seed))
    batches = micro_batches(t_arr, sparse, dense,
                            max_size=args.max_batch,
                            max_wait_s=args.max_wait_ms * 1e-3)
    W = sparse.shape[1]

    lat_h = reg.histogram("serve.latency_s", keep=True)
    stale_h = reg.histogram("serve.staleness_age", keep=True)
    slo_c = reg.counter("serve.slo_violations")
    req_c = reg.counter("serve.requests")
    refresh_c = reg.counter("serve.refresh_rows")
    bad_c = reg.counter("serve.nonfinite_logits")
    # host-clock layer breakdown: Alg. 2 decision per batch, and one
    # worker's refresh + serve step + synchronise
    decide_h = reg.histogram("serve.decide_s")
    worker_h = reg.histogram("serve.worker_step_s")

    # warm up off the clock: builds the kernels and the allocator pools
    pad_sparse = np.full((args.max_batch, W), -1, np.int64)
    pad_dense = np.zeros((args.max_batch, wl.n_dense), np.float32)
    serve_step(model, planes[0], pad_sparse, pad_dense, 0)
    # the refresh runs in place: warm it up on a scratch copy
    scratch = PrefetchPlane(ids=planes[0].ids.clone(),
                            rows=planes[0].rows.clone(),
                            expiry=planes[0].expiry.clone())
    refresh_plane(scratch, table, 0, ttl=args.ttl_batches,
                  budget=args.refresh_budget, codec=codec)
    _sync(device)

    rng = np.random.default_rng(args.seed + 2)
    busy_until = np.zeros(n)
    served = np.zeros(n, np.int64)
    marginal = np.full(n, 1e-4)
    cap_b = max(1, int(np.ceil(args.max_batch / n * 2.0)))
    t0 = time.perf_counter()
    for bi, b in enumerate(batches):
        lag = b.t_close - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        now = time.perf_counter() - t0
        queue_s = np.maximum(busy_until - now, 0.0)
        slack = (b.t_arrive + slo_s) - now
        t_dec0 = time.perf_counter()
        if args.mechanism == "esd":
            C = serve_cost_matrix(b.sparse, resident, t_row, queue_s,
                                  marginal, slack,
                                  slo_penalty=args.slo_penalty)
            assign = serve_decide(C, cap=cap_b, alpha=args.alpha)
        else:
            assign = rng.integers(0, n, len(b.t_arrive))
        decide_s = decide_h.observe(time.perf_counter() - t_dec0)
        n_refresh = 0
        for j in np.unique(assign[:len(b.t_arrive)][b.valid]):
            t_w0 = time.perf_counter()
            rows = b.valid & (assign == j)
            sp = np.where(rows[:, None], b.sparse, -1)
            dn = np.where(rows[:, None], b.dense, 0.0).astype(np.float32)
            planes[j], n_ref = refresh_plane(
                planes[j], table, bi, ttl=args.ttl_batches,
                budget=args.refresh_budget, codec=codec)
            logits, _ = serve_step(model, planes[j], sp, dn, bi)
            _sync(device)
            n_refresh += int(n_ref)
            done = time.perf_counter() - t0
            worker_h.observe(time.perf_counter() - t_w0)
            busy_until[j] = done
            served[j] += int(rows.sum())
            ok = torch.isfinite(logits.cpu()[torch.from_numpy(rows)])
            bad_c.inc(int((~ok).sum()))
            for lat in done - b.t_arrive[rows]:
                lat_h.observe(float(lat))
                req_c.inc()
                if lat > slo_s:
                    slo_c.inc()
        refresh_c.inc(n_refresh)
        if bi % args.log_every == 0:
            ages = plane_ages(planes[0], bi, ttl=args.ttl_batches)
            for a in ages[ages >= 0]:
                stale_h.observe(float(a))
            log_step({"step": bi, "wall_s": round(now, 4),
                      "decide_ms": round(decide_s * 1e3, 3),
                      "n_req": int(b.n),
                      "n_refresh": n_refresh})

    n_req = req_c.value
    out = {
        "mechanism": args.mechanism,
        "codec": codec_name(codec),
        "device": str(device),
        "n_requests": n_req,
        "n_batches": len(batches),
        "p50_ms": lat_h.quantile(0.5) * 1e3,
        "p99_ms": lat_h.quantile(0.99) * 1e3,
        "mean_ms": (lat_h.mean or 0.0) * 1e3,
        "slo_violation_rate": slo_c.value / n_req if n_req else 0.0,
        "qps_per_worker": [float(s / max(args.duration, 1e-9))
                           for s in served],
        "refresh_rows": refresh_c.value,
        "staleness_age_p99": (stale_h.quantile(0.99)
                              if stale_h.count else 0.0),
        "nonfinite_logits": bad_c.value,
        "decide_ms_mean": decide_h.mean * 1e3,
        "worker_steps": worker_h.count,
        "worker_step_ms_mean": worker_h.mean * 1e3,
    }
    log_step({k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in out.items()})
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_serve(args)


if __name__ == "__main__":
    main()
