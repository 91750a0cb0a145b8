"""The paper's simulator and its host-side parts: repro_torch against the
JAX package on the CPU.

The port's simulator is the reference's numpy, line for line, with the
auction ``Opt`` in PyTorch (its bids through the bid kernel's plain
version on the CPU).  Every field of a result must be equal, floats bit
for bit, except the wall-clock decision times of
``decision_model="measured"``.  The auction runs on configurations whose
decisions take a few thousand rounds: a cold cache on the paper's two
bandwidth classes starts a price war of up to a million rounds, which
the reference runs the same way (ROADMAP § C).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core import cost as JCOST
from repro.core.hungarian import assignment_cost as j_assignment_cost
from repro.core import simulator as JS
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.exchange.plan import compile_plan as j_compile_plan
from repro.pipeline.window import LookaheadWindow as JWindow
from repro.pipeline.window import window_meta as j_window_meta
from repro.ps import make_partition as j_make_partition
from repro.serve.sim import ServeKnobs as JKnobs
from repro_torch.core import cache as TC
from repro_torch.core import cost as TCOST
from repro_torch.core.hungarian import assignment_cost as t_assignment_cost
from repro_torch.core import simulator as TS
from repro_torch.data.synthetic import WORKLOADS as T_WORKLOADS
from repro_torch.exchange.plan import compile_plan as t_compile_plan
from repro_torch.pipeline.window import LookaheadWindow as TWindow
from repro_torch.pipeline.window import window_meta as t_window_meta
from repro_torch.ps import make_partition as t_make_partition
from repro_torch.serve import ServeKnobs as TKnobs
from repro_torch.serve import simulate_serve

BASE = dict(n_workers=4, batch_per_worker=8, iters=6, warmup=2)
# distinct link speeds: no two workers tie, so a cold cache starts no
# price war in the auction
DISTINCT_BW = np.array([5.0, 2.0, 1.0, 0.5]) * JS.GBPS
WALL_CLOCK = {"decision_time_mean", "per_iter_time", "itps",
              "pipeline.decision_stage_mean_s",
              "metrics.dispatch.decision_s", "metrics.sim.iter_time_s"}


def _same(a, b, path, skip=frozenset()):
    if path in skip:
        return
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            _same(a[key], b[key], f"{path}.{key}" if path else key, skip)
    elif isinstance(a, (np.ndarray, list, tuple)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _results_equal(want, got, skip=frozenset()):
    assert type(want).__name__ == type(got).__name__
    for f in dataclasses.fields(want):
        _same(getattr(want, f.name), getattr(got, f.name), f.name, skip)


def _both(wl="tiny", skip=frozenset(), **kw):
    cfg = {**BASE, **kw}
    want = JS.simulate(JS.SimConfig(workload=J_WORKLOADS[wl], **cfg))
    got = TS.simulate(TS.SimConfig(workload=T_WORKLOADS[wl], device="cpu",
                                   **cfg))
    _results_equal(want, got, skip)
    return got


@pytest.mark.parametrize("cfg", [
    dict(opt="ssp"),
    dict(opt="hungarian"),
    dict(opt="auction", bandwidths=DISTINCT_BW),
    dict(opt="auction", n_workers=2),
    dict(opt="auction", alpha=0.5, hybrid_variant="opt_first",
         bandwidths=DISTINCT_BW, iters=4),
    dict(mechanism="laia"),
    dict(mechanism="het"),
    dict(mechanism="het", het_staleness=2),
    dict(mechanism="fae"),
    dict(mechanism="random"),
    dict(engine="dense"),
    dict(engine="dense", opt="auction", n_workers=2),
    dict(n_ps=2, ps_bandwidths=JS.hetero_ps_bandwidths(4, 2)),
    dict(n_ps=2, ps_layout="hashed", mechanism="het", het_staleness=2),
    dict(n_ps=2, mechanism="fae"),
    dict(exchange="padded"),
    dict(exchange="ragged", cap_slack=0.5),
    dict(lookahead=3),
    dict(lookahead=3, prefetch=True),
    dict(lookahead=2, n_ps=2, ps_layout="hashed"),
    dict(codec="int8"),
    dict(codec="int8", codec_policy="bandwidth"),
    dict(codec="int4", n_ps=2, ps_bandwidths=JS.hetero_ps_bandwidths(4, 2)),
    dict(pipeline_depth=1, alpha=0.5),
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()
                          if not isinstance(v, np.ndarray)))
def test_simulate_matches_reference(cfg):
    res = _both(**cfg)
    assert np.isfinite(res.per_iter_cost).all()
    assert len(res.per_iter_cost) == \
        cfg.get("iters", BASE["iters"]) - BASE["warmup"]


@pytest.mark.parametrize("opt", ["ssp", "auction"])
def test_simulate_measured_decisions(opt):
    res = _both(skip=WALL_CLOCK, opt=opt, decision_model="measured",
                bandwidths=DISTINCT_BW, exchange="ragged")
    assert res.decision_time_mean > 0


def test_simulate_defaults_and_unported_options():
    cfg = TS.SimConfig(workload=T_WORKLOADS["tiny"])
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.simulate(cfg)
    # faults are ported (tests/test_torch_simulator_elastic.py): a plan
    # for another cluster is refused with the reference's message
    from repro.elastic import FaultPlan as JPlan
    from repro_torch.elastic import FaultPlan as TPlan
    with pytest.raises(ValueError) as want:
        JS.simulate(JS.SimConfig(workload=J_WORKLOADS["tiny"],
                                 faults=JPlan.empty(3)))
    with pytest.raises(ValueError) as got:
        TS.simulate(TS.SimConfig(workload=T_WORKLOADS["tiny"], device="cpu",
                                 faults=TPlan.empty(3)))
    assert str(got.value) == str(want.value)
    assert TS.calibrated_decision_time(128, 1.0) == \
        JS.calibrated_decision_time(128, 1.0)


@pytest.mark.parametrize("kw", [
    dict(mechanism="esd"),
    dict(mechanism="esd", opt="auction", n_workers=2),
    dict(mechanism="random"),
    dict(mechanism="esd", codec="int8", codec_policy="bandwidth"),
    dict(mechanism="esd", n_ps=2, ps_layout="hashed"),
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_simulate_serve_matches_reference(kw):
    knobs = dict(qps=3000.0, duration_s=0.15, slo_ms=5.0, max_batch=8,
                 burst_at_s=0.05, burst_dur_s=0.03, burst_x=3.0,
                 drift_period_s=0.07)
    cfg = {**dict(n_workers=4, cache_ratio=0.05, seed=3), **kw}
    want = JS.simulate(JS.SimConfig(workload=J_WORKLOADS["tiny"],
                                    serve=JKnobs(**knobs), **cfg))
    got = simulate_serve(TS.SimConfig(workload=T_WORKLOADS["tiny"],
                                      serve=TKnobs(**knobs), device="cpu",
                                      **cfg))
    _results_equal(want, got)
    assert got.n_requests > 0


@pytest.mark.parametrize("layout", ["contiguous", "hashed"])
@pytest.mark.parametrize("vocab,n_ps", [(1000, 1), (1001, 3), (64, 4)])
def test_partition_matches_reference(layout, vocab, n_ps):
    jp, tp = j_make_partition(vocab, n_ps, layout), \
        t_make_partition(vocab, n_ps, layout)
    assert (jp.max_rows, jp.linear_size, jp.bounds) == \
        (tp.max_rows, tp.linear_size, tp.bounds)
    ids = np.random.default_rng(vocab).integers(-1, vocab, 200)
    lin = np.asarray(jp.to_linear(ids))
    for fn in ("shard_of", "to_linear", "global_to_local"):
        want = getattr(jp, fn)(ids)
        got_np = getattr(tp, fn)(ids)
        got_t = getattr(tp, fn)(torch.from_numpy(ids))
        want_j = getattr(jp, fn)(jnp.asarray(ids, jnp.int32))
        for w, g, t, wj in zip(*(x if isinstance(x, tuple) else (x,)
                                 for x in (want, got_np, got_t, want_j))):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            np.testing.assert_array_equal(t.numpy(), np.asarray(wj))
    for fn in ("from_linear", "shard_of_linear"):
        np.testing.assert_array_equal(getattr(tp, fn)(lin),
                                      np.asarray(getattr(jp, fn)(lin)))
        np.testing.assert_array_equal(
            getattr(tp, fn)(torch.from_numpy(lin)).numpy(),
            np.asarray(getattr(jp, fn)(lin)))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("active", [None, [True, True, False, True]])
def test_compile_plan_matches_reference(codec, active):
    rng = np.random.default_rng(4)
    n, m = 4, 16
    assign = rng.integers(0, n, n * m)
    if active is not None:
        assign = np.where(assign == 2, 3, assign)
        active = np.asarray(active)
    kw = dict(row_bytes=296, cap=m, active=active)
    if codec:
        kw.update(codec=codec, row_elems=13)
    want = j_compile_plan(assign, n, m, **kw)
    got = t_compile_plan(assign, n, m, **kw)
    _same(dataclasses.asdict(want), dataclasses.asdict(got), "")
    _same(want.stats.summary(), got.stats.summary(), "")


def test_window_meta_matches_reference():
    rng = np.random.default_rng(6)
    wl = T_WORKLOADS["tiny"]
    batches = [wl.sample_batch(rng, 8) for _ in range(7)]
    want, got = j_window_meta(batches), t_window_meta(batches)
    _same(dataclasses.asdict(want), dataclasses.asdict(got), "")
    jw, tw = JWindow(iter(batches), 3), TWindow(iter(batches), 3)
    for (jb, jm), (tb, tm) in zip(jw, tw):
        np.testing.assert_array_equal(tb, jb)
        _same(dataclasses.asdict(jm), dataclasses.asdict(tm), "")


@pytest.mark.parametrize("engine", ["dense", "sparse"])
@pytest.mark.parametrize("policy", ["emark", "lru", "lfu"])
def test_cluster_cache_steps_match_reference(engine, policy):
    rng = np.random.default_rng(8)
    wl = T_WORKLOADS["tiny"]
    V, n = wl.vocab, 4
    part = None
    caches = []
    for mod in (JC, TC):
        cls = mod.SparseClusterCache if engine == "sparse" \
            else mod.ClusterCache
        caches.append(cls(n, V, int(0.05 * V), policy=policy, part=part))
    for step in range(5):
        samples = wl.sample_batch(rng, 4 * n)
        assign = rng.integers(0, n, 4 * n)
        batches = TS._worker_batches(samples, assign, n, V)
        for a, b in zip(batches, JS._worker_batches(samples, assign, n, V)):
            np.testing.assert_array_equal(a, b)
        want, got = (c.step(batches) for c in caches)
        _same(dataclasses.asdict(want), dataclasses.asdict(got), "")
        uids = np.unique(samples[samples >= 0])
        for a, b in zip(caches[0].state_columns(uids),
                        caches[1].state_columns(uids)):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n_ps", [1, 3])
def test_numpy_alg1_matches_reference(n_ps):
    rng = np.random.default_rng(n_ps)
    wl = T_WORKLOADS["tiny"]
    n, V = 4, wl.vocab
    samples = wl.sample_batch(rng, 12)
    latest = rng.random((n, V)) < 0.3
    dirty = latest & (rng.random((n, V)) < 0.4)
    t = TS.transmission_time(2048.0, TS.DEFAULT_BANDWIDTHS(n))
    t_ps = TS.transmission_time(2048.0, TS.hetero_ps_bandwidths(n, n_ps))
    part = t_make_partition(V, n_ps)
    pairs = [
        (JCOST.cost_matrix_np(samples, latest, dirty, t),
         TCOST.cost_matrix_np(samples, latest, dirty, t)),
        (JCOST.cost_matrix_sparse(samples, latest, dirty, t),
         TCOST.cost_matrix_sparse_np(samples, latest, dirty, t)),
        (JCOST.cost_matrix_sparse_ps(samples, latest, dirty, t_ps,
                                     j_make_partition(V, n_ps)),
         TCOST.cost_matrix_sparse_ps_np(samples, latest, dirty, t_ps, part)),
    ]
    for want, got in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assign = np.argmin(pairs[0][1], axis=1)
    assert t_assignment_cost(pairs[0][1], assign) == \
        j_assignment_cost(pairs[0][0], assign)
