"""Alg. 1 for all n workers in one launch (``kernels/emb_lookup.py::
alg1_cost``, ``kernels/ops.py::cost_matrix_batched_kernel``) against the
per-worker route it replaces on the decide stage (``core/dispatch.py::
esd_cost_matrix``: a compact per-id table pooled on B1), on the CPU.

Bit for bit, under ``torch.equal``: a tied auction cost breaks on the
last bit.  The inputs hold PAD slots, an id repeated within a sample,
ids 0 and V - 1, all-hit, all-miss and dirty-heavy planes, the paper's
link times and the int8 wire's codec-priced ones.  ``esd_decide`` takes
the one launch where its inputs allow (one PS, the sparse cost, (n,)
link times, n <= 32) and says so in its ``decide.cost`` span's
``fused``; the card's kernel is held in ``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch.obs as T
from repro_torch.core import dispatch as D
from repro_torch.core.cost import transmission_time_codec
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
from repro_torch.kernels import emb_lookup as K
from repro_torch.kernels.ops import cost_matrix_batched_kernel
from repro_torch.ps import make_partition
from repro_torch.quant.codecs import resolve_link_codecs

V, E = 97, 512


def _samples(rng, n, m, F):
    s = rng.integers(0, V, (n, m, F)).astype(np.int32)
    s[rng.random((n, m, F)) < 0.2] = -1                  # PAD slots
    if F > 1:
        s[:, 0, 1] = s[:, 0, 0] = 5                      # a repeat
        s[:, 1, 0], s[:, 1, F - 1] = 0, V - 1            # the ends
        s[:, 2, F - 1] = s[:, 2, F // 2]                 # a late repeat
    else:
        s[:, 0, 0], s[:, 1, 0] = 0, V - 1
    return torch.from_numpy(s)


def _planes(rng, n, kind):
    if kind == "all_hit":
        lat = np.ones((n, V), bool)
        dirty = np.zeros((n, V), bool)
    elif kind == "all_miss":
        lat = dirty = np.zeros((n, V), bool)
    elif kind == "dirty_heavy":
        lat = rng.random((n, V)) < 0.9
        dirty = lat & (rng.random((n, V)) < 0.8)
    else:
        lat = rng.random((n, V)) < 0.4
        dirty = lat & (rng.random((n, V)) < 0.3)
    return torch.from_numpy(lat.copy()), torch.from_numpy(dirty.copy())


def _links(n, codec):
    bw = DEFAULT_BANDWIDTHS(n)
    return torch.tensor(transmission_time_codec(
        E, bw, resolve_link_codecs("uniform", bw, codec)),
        dtype=torch.float32)


def _state(lat, dirty):
    return D.SparseEsdState(lat, dirty, None, None, None)


def _loop(samples, state, t, col_bias=None, **kw):
    return torch.stack([D.esd_cost_matrix(samples[i], state, t, col_bias,
                                          **kw)
                        for i in range(samples.shape[0])])


@pytest.mark.parametrize("F", [1, 26, 74])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 32])
def test_batched_equals_the_per_worker_route(n, F):
    rng = np.random.default_rng(n * 100 + F)
    m = 6
    samples = _samples(rng, n, m, F)
    bias = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-3)
    n0 = dict(K.LAUNCHES)
    for kind in ("random", "all_hit", "all_miss", "dirty_heavy"):
        lat, dirty = _planes(rng, n, kind)
        for codec in (None, "int8"):
            t = _links(n, codec)
            want = _loop(samples, _state(lat, dirty), t)
            got = cost_matrix_batched_kernel(samples, lat, dirty, t)
            assert got.shape == (n, m, n)
            assert torch.equal(got, want), (kind, codec)
            assert torch.equal(K.alg1_cost_ref(samples, lat, dirty, t), want)
            with_bias = _loop(samples, _state(lat, dirty), t, bias)
            assert torch.equal(got + bias[None, None, :], with_bias)
    assert K.LAUNCHES == n0               # the CPU runs no kernel


def test_batched_reads_planes_with_a_row_stride():
    """The sparse engine's planes are (n, V) views of (n, V + 1) tensors:
    the wrapper takes them as they are."""
    rng = np.random.default_rng(3)
    n, m, F = 4, 8, 26
    samples = _samples(rng, n, m, F)
    lat, dirty = _planes(rng, n, "random")
    wide = torch.cat([lat, lat[:, :1]], 1)[:, :V]
    wide_d = torch.cat([dirty, dirty[:, :1]], 1)[:, :V]
    assert not wide.is_contiguous()
    t = _links(n, None)
    assert torch.equal(K.alg1_cost(samples, wide, wide_d, t),
                       K.alg1_cost(samples, lat, dirty, t))


def test_alg1_cost_raises_on_what_it_does_not_take():
    n, m, F = 2, 3, 4
    s = torch.zeros((n, m, F), dtype=torch.int32)
    lat = torch.zeros((n, V), dtype=torch.bool)
    t = torch.ones(n)
    with pytest.raises(TypeError):
        K.alg1_cost(s.long(), lat, lat, t)
    with pytest.raises(TypeError):
        K.alg1_cost(s, lat.float(), lat, t)
    with pytest.raises(ValueError):
        K.alg1_cost(s, lat, lat[:, :-1], t)
    with pytest.raises(ValueError):
        K.alg1_cost(s, lat[:1], lat, t)
    with pytest.raises(ValueError):               # column stride n
        K.alg1_cost(s, lat.t().contiguous().t(), lat, t)
    big = K.ALG1_MAX_WORKERS + 1
    with pytest.raises(ValueError):
        K.alg1_cost(torch.zeros((big, 1, F), dtype=torch.int32),
                    torch.zeros((big, V), dtype=torch.bool),
                    torch.zeros((big, V), dtype=torch.bool), torch.ones(big))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("n", [4, 8])
def test_esd_decide_assigns_as_the_loop(n, with_bias):
    """The batched route's assignment and Alg.-1 objective are the
    per-worker route's under Alg. 2 (auction and greedy)."""
    rng = np.random.default_rng(n + 11 * with_bias)
    m, F = 16, 26
    samples = _samples(rng, n, m, F)
    lat, dirty = _planes(rng, n, "random")
    state = _state(lat, dirty)
    t = _links(n, None)
    bias = (torch.from_numpy(rng.random(n).astype(np.float32) * 1e-4)
            if with_bias else None)
    for alpha in (1.0, 0.5):
        got, obj = D.esd_decide(samples, state, t, alpha, with_cost=True,
                                col_bias=bias)
        C = _loop(samples, state, t, bias)
        want = D.hybrid_dispatch(C, m, alpha, cap=D.dispatch_cap(m, n))
        want_obj = torch.gather(C, 2, want.long()[:, :, None])[:, :, 0].sum(1)
        assert torch.equal(got, want), alpha
        assert torch.equal(obj, want_obj), alpha


def _fused(call):
    tr = T.Tracer(capacity=64)
    with T.use_tracer(tr):
        call()
    return [s["args"]["fused"] for s in tr.spans()
            if s["name"] == "decide.cost"]


def test_decide_cost_span_counts_the_fused_workers():
    rng = np.random.default_rng(1)
    n, m, F = 4, 8, 6
    samples = _samples(rng, n, m, F)
    lat, dirty = _planes(rng, n, "random")
    state = _state(lat, dirty)
    t = _links(n, None)
    assert _fused(lambda: D.esd_decide(samples, state, t, 0.0)) == [n]
    one_ps = make_partition(V, 1)
    assert _fused(lambda: D.esd_decide(samples, state, t, 0.0,
                                       part=one_ps)) == [n]
    # the dense table
    assert _fused(lambda: D.esd_decide(samples, state, t, 0.0,
                                       sparse_cost=False)) == [0]
    # two PS: per-shard link times (n, 2) over PS-linearized ids
    part = make_partition(V, 2)
    lin = part.to_linear(samples)
    Vs = part.linear_size
    lat2 = torch.from_numpy(rng.random((n, Vs)) < 0.4)
    st2 = _state(lat2, lat2 & torch.from_numpy(rng.random((n, Vs)) < 0.3))
    t2 = t[:, None].repeat(1, 2).contiguous()
    assert _fused(lambda: D.esd_decide(lin, st2, t2, 0.0, part=part)) == [0]
    # more workers than a warp's lanes
    big = K.ALG1_MAX_WORKERS + 1
    s_big = _samples(rng, big, big, 2)
    lat_b, dirty_b = _planes(rng, big, "random")
    assert _fused(lambda: D.esd_decide(s_big, _state(lat_b, dirty_b),
                                       _links(big, None), 0.0)) == [0]


def _route_inputs(rng, route):
    """(samples, state, t, kw, fused) for each route
    ``esd_cost_matrices`` chooses between."""
    n, m, F = (K.ALG1_MAX_WORKERS + 1, 5, 3) if route == "n33" else (4, 8, 6)
    samples = _samples(rng, n, m, F)
    lat, dirty = _planes(rng, n, "random")
    t, kw = _links(n, None), {}
    if route == "one_ps_part":
        kw["part"] = make_partition(V, 1)
    elif route == "dense":
        kw["sparse_cost"] = False
    elif route == "two_ps":
        part = kw["part"] = make_partition(V, 2)
        samples = part.to_linear(samples)
        Vs = part.linear_size
        lat = torch.from_numpy(rng.random((n, Vs)) < 0.4)
        dirty = lat & torch.from_numpy(rng.random((n, Vs)) < 0.3)
        t = t[:, None].repeat(1, 2).contiguous()
    fused = n if route in ("one_ps", "one_ps_part") else 0
    return samples, _state(lat, dirty), t, kw, fused


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("route", ["one_ps", "one_ps_part", "dense",
                                   "two_ps", "n33"])
def test_esd_cost_matrices_picks_the_route(route, with_bias):
    """One launch for one PS, the sparse cost, (n,) links and n <= 32;
    the per-worker loop for the dense table, 2 PS and n = 33; the same
    bits either way."""
    rng = np.random.default_rng(len(route) + 7 * with_bias)
    samples, state, t, kw, fused = _route_inputs(rng, route)
    n = samples.shape[0]
    bias = (torch.from_numpy(rng.random(n).astype(np.float32) * 1e-3)
            if with_bias else None)
    C, got = D.esd_cost_matrices(samples, state, t, bias, **kw)
    assert got == fused
    assert torch.equal(C, _loop(samples, state, t, bias, **kw))


def test_repair_prices_on_the_batched_route():
    """The commit-time repair (``launch/steps.py``) re-places the flagged
    samples against the committed state's matrices from one launch: the
    per-worker loop's result."""
    from repro_torch.launch.steps import make_dlrm_repair_stage

    rng = np.random.default_rng(5)
    n, m, F = 4, 8, 6
    samples = _samples(rng, n, m, F)
    decided = _state(*_planes(rng, n, "random"))
    committed = _state(*_planes(rng, n, "dirty_heavy"))
    t = _links(n, None)
    assign = torch.from_numpy(rng.integers(0, n, n * m).astype(np.int32))
    repair = make_dlrm_repair_stage(n, m, t)
    got, n_re = repair(committed, decided, samples.reshape(n * m, F), assign)
    flagged = D.changed_samples_mask(samples, decided, committed)
    want, want_re = D.esd_reassign(_loop(samples, committed, t),
                                   assign.reshape(n, m), flagged,
                                   D.dispatch_cap(m, n))
    assert int(n_re) == int(want_re) > 0
    assert torch.equal(got, want.reshape(-1))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _read_span_metrics(args):
    """The benchmark's two readers of ``decide.cost`` on a fixed run of 4
    workers: steps 0-3, window from step 1, decide [10t + 2, 10t + 6]
    holding decide.cost [10t + 2.5, 10t + 2.5 + 0.5 (t + 1)] with
    ``args``."""
    from esdbench.harness import Run
    from esdbench.manifest import HERE, Bench

    read = Bench(HERE.parent).reader
    clk = _Clock()
    tr = T.Tracer(capacity=64, clock=clk)
    with T.use_tracer(tr):
        for t in range(4):
            clk.t = 10.0 * t + 2
            d = tr.span("decide", step=t)
            clk.t = 10.0 * t + 2.5
            c = tr.span("decide.cost", **args)
            clk.t += 0.5 * (t + 1)
            c.end()
            clk.t = 10.0 * t + 6
            d.end()
        run = Run({}, {"workers": 4, "pipeline_depth": 1}, 1.0, 8, first=1)
        run.rec = {t: 10.0 * t + 9.0 for t in range(4)}
        run.t0, run.deadline = 9.0, 60.0
        return {name: read(name)(run)
                for name in ("decide_cost_ms", "alg1_fused_share")}


def test_benchmark_reads_the_decide_cost_span():
    got = _read_span_metrics({"fused": 4})
    # steps 1-3: 1, 1.5 and 2 s
    assert got["decide_cost_ms"] == pytest.approx(1500.0)
    assert got["alg1_fused_share"] == 1.0
    assert _read_span_metrics({"fused": 0})["alg1_fused_share"] == 0.0
    # a program whose span counts nothing: the share reads nothing
    got = _read_span_metrics({})
    assert got["alg1_fused_share"] is None
    assert got["decide_cost_ms"] == pytest.approx(1500.0)
