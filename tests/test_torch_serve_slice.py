"""The serving slice as a whole: repro_torch against the JAX package.

``run_serve``'s loop reads the wall clock for each request's slack and
each worker's queue, which makes its decisions vary from run to run.
The replay below is that loop with the clock taken out: every worker's
queue is 0 and a request's slack is measured from its batch's close
time.  It runs once on the reference's functions and once on the
port's (plain kernel versions on the CPU).  The reference's serve step
reaches its Pallas ``pooled_lookup_staged`` in interpret mode; its
refresh takes the reference's default gather, which its own tests hold
bitwise equal to the Pallas ``staged_gather`` (interpreting that kernel
over a 1,100-slot plane in every round would take most of a minute).
Assignments, refresh counts and the planes' ids, expiry and rows must
match exactly; logits and pooled bags are f32 sums taken in
another order, so rtol = atol = 1e-5.
"""
import types

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.configs import DLRM_CONFIGS as J_CONFIGS
from repro.core.cost import transmission_time_codec as j_t_row
from repro.core.simulator import DEFAULT_BANDWIDTHS as J_BW
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.models import dlrm as jdlrm
from repro.serve.sim import _hot_set as j_hot_set
import repro_torch.serve as tserve
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.cost import transmission_time_codec as t_t_row
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS as T_BW
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.serve import build_parser, run_serve
from repro_torch.models.dlrm import params_from_jax
from repro_torch.serve.sim import _hot_set as t_hot_set

ARCH, N, TTL, BUDGET, MAX_BATCH, SLO_S = "wdl-tiny", 4, 4, 8, 16, 0.02
N_BATCHES = 20

JAX_SIDE = types.SimpleNamespace(
    cfg=J_CONFIGS[ARCH], wl=J_WORKLOADS["tiny"], hot_set=j_hot_set,
    t_row=j_t_row, bw=J_BW, serve=jserve,
    step=lambda cfg, F: jserve.make_serve_step(cfg, F, use_pallas=True,
                                               interpret=True),
    refresh=lambda plane, table, step: jserve.refresh_plane(
        plane, table, step, ttl=TTL, budget=BUDGET))
TORCH_SIDE = types.SimpleNamespace(
    cfg=DLRM_CONFIGS[ARCH], wl=WORKLOADS["tiny"], hot_set=t_hot_set,
    t_row=t_t_row, bw=T_BW, serve=tserve,
    step=tserve.make_serve_step,
    refresh=lambda plane, table, step: tserve.refresh_plane(
        plane, table, step, ttl=TTL, budget=BUDGET))


def _replay(side, model, table):
    s, wl = side.serve, side.wl
    cap = int(0.25 * wl.vocab)
    hot = side.hot_set(wl, np.random.default_rng(1), 2048, cap)
    planes = [s.seed_plane(table, hot, step=0, ttl=TTL) for _ in range(N)]
    resident = np.zeros((N, wl.vocab), bool)
    resident[:, hot] = True
    t_row = side.t_row(side.cfg.embedding_dim, side.bw(N))
    serve_step = side.step(side.cfg, wl.n_fields)
    batches = s.micro_batches(*s.request_arrivals(s.StreamConfig(
        workload=wl, qps=3000.0, duration_s=0.1, seed=0)),
        max_size=MAX_BATCH, max_wait_s=0.005)[:N_BATCHES]
    cap_b = int(np.ceil(MAX_BATCH / N * 2.0))
    log = dict(assign=[], n_refresh=[], logits=[], pooled=[])
    for bi, b in enumerate(batches):
        slack = (b.t_arrive + SLO_S) - b.t_close
        C = s.serve_cost_matrix(b.sparse, resident, t_row, np.zeros(N),
                                np.full(N, 1e-4), slack)
        assign = s.serve_decide(C, cap=cap_b)
        log["assign"].append(assign)
        for j in np.unique(assign[b.valid]):
            rows = b.valid & (assign == j)
            sp = np.where(rows[:, None], b.sparse, -1)
            dn = np.where(rows[:, None], b.dense, 0.0).astype(np.float32)
            planes[j], n_ref = side.refresh(planes[j], table, bi)
            log["n_refresh"].append(int(n_ref))
            logits, pooled = serve_step(model, planes[j], sp, dn, bi)
            log["logits"].append(np.asarray(logits)[rows])
            log["pooled"].append(np.asarray(pooled)[rows])
    log["planes"] = [tuple(np.asarray(getattr(p, f))
                           for f in ("ids", "expiry", "rows"))
                     for p in planes]
    return log, len(batches)


def test_replay_matches_jax():
    params = jax.tree.map(np.asarray, jdlrm.init_params(
        jax.random.key(0), J_CONFIGS[ARCH], J_WORKLOADS["tiny"]))
    model = params_from_jax(params, DLRM_CONFIGS[ARCH])
    want, nb = _replay(JAX_SIDE, params, params["embed"])
    got, _ = _replay(TORCH_SIDE, model, model.embed.detach())
    assert nb == N_BATCHES
    assert sum(want["n_refresh"]) > 0            # the TTL lapsed in the run
    assert len({int(j) for a in want["assign"] for j in a}) > 1
    for a, b in zip(got["assign"], want["assign"]):
        np.testing.assert_array_equal(a, b)
    assert got["n_refresh"] == want["n_refresh"]
    for tp, jp in zip(got["planes"], want["planes"]):
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
    for key in ("logits", "pooled"):
        np.testing.assert_allclose(np.concatenate(got[key]),
                                   np.concatenate(want[key]),
                                   rtol=1e-5, atol=1e-5)


def test_run_serve_on_cpu():
    args = build_parser().parse_args(
        ["--arch", "wdl-tiny", "--duration", "0.3", "--device", "cpu",
         "--ttl-batches", "4", "--refresh-budget", "8", "--qps", "400"])
    out = run_serve(args)
    wl = WORKLOADS["tiny"]
    n_stream = len(tserve.request_arrivals(tserve.StreamConfig(
        workload=wl, qps=400.0, duration_s=0.3, seed=0))[0])
    assert out["n_requests"] == n_stream > 0
    assert out["nonfinite_logits"] == 0
    assert out["refresh_rows"] > 0
    assert np.isfinite([out["p50_ms"], out["p99_ms"]]).all()
    assert out["device"] == "cpu"


@pytest.mark.parametrize("policy", ["uniform", "bandwidth"])
def test_run_serve_with_codec_on_cpu(policy):
    args = build_parser().parse_args(
        ["--arch", "wdl-tiny", "--duration", "0.3", "--device", "cpu",
         "--ttl-batches", "4", "--refresh-budget", "8", "--qps", "400",
         "--codec", "int8", "--codec-policy", policy])
    out = run_serve(args)
    n_stream = len(tserve.request_arrivals(tserve.StreamConfig(
        workload=WORKLOADS["tiny"], qps=400.0, duration_s=0.3, seed=0))[0])
    assert out["codec"] == "int8"
    assert out["n_requests"] == n_stream > 0
    assert out["nonfinite_logits"] == 0
    assert out["refresh_rows"] > 0


def test_run_serve_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serve(build_parser().parse_args(["--duration", "0.1"]))
