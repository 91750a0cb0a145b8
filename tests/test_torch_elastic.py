"""The elastic modules: repro_torch.elastic against the JAX package's
repro.elastic on the same numpy inputs, on the CPU.

* ``FaultPlan``: the DSL, JSON in and out, validation (the same
  ``ValueError`` messages), ``state_at`` windows, ``events_at``,
  ``max_inactive`` and ``random`` (one seed, one plan in both
  packages): equal.
* ``effective_t`` and ``cost_column_bias`` (numpy, and the bias on a
  torch mask): exact.
* ``mask_state`` on the sparse engine's state and on the dense
  engine's (torch against jnp), and on the dense engine's planes as
  numpy: exact, and every plane unchanged bit for bit with all workers
  active.
* The crash, departure and rejoin handoffs on both numpy cache engines
  (``ClusterCache``, ``SparseClusterCache``): the handoff plans and
  every cache plane after them, exact.
* ``gap_bound`` exact, and ``replay_dispatch`` re-deriving the
  uninterrupted run's cache state through the port's stages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core import dispatch_tpu as JD
from repro import elastic as JE
from repro_torch import elastic as TE
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core import cache as TC
from repro_torch.core import dispatch as TD
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.steps import make_dlrm_esd_stages

SPECS = [
    "crash@3:1g; rejoin@6:1w, straggle@2:0x4-10; bw@5:2x0.25-12",
    "crash@1:0; crash@2:1; rejoin@4:0; crash@6:2; straggle@0:3x2.5",
    "straggle@1:0x4-8; crash@3:1g; bw@4:2x0.25-10; rejoin@7:1w",
    "crash@2:3g; rejoin@5:3w; straggle@1:0x4-6; bw@3:5x0.25-7",
    "crash@2:1; rejoin@2:1; crash@2:2; bw@0:0x1e-1-3",
    "",
]
BAD = ["crash@1:0; crash@2:0", "rejoin@1:0", "crash@0:0; crash@0:1",
       "straggle@0:0x0.5", "bw@0:0x0", "crash@0:9", "straggle@5:0x2-3",
       "crash@three:1", "flood@1:0"]


def _events(plan):
    return [e.to_dict() for e in plan.events]


def _state_equal(a, b):
    for f in ("active", "compute_factor", "bw_factor", "ps_bw_factor"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype


# --------------------------------------------------------------------------
# FaultPlan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_plan_parse_and_queries(spec):
    n = 6
    jp, tp = JE.FaultPlan.parse(spec, n), TE.FaultPlan.parse(spec, n)
    assert _events(tp) == _events(jp)
    assert (tp.n_workers, tp.n_ps) == (jp.n_workers, jp.n_ps)
    assert tp.max_inactive() == jp.max_inactive()
    for t in range(14):
        _state_equal(tp.state_at(t), jp.state_at(t))
        assert tp.state_at(t).n_active == jp.state_at(t).n_active
        assert tp.state_at(t).healthy == jp.state_at(t).healthy
        assert ([e.to_dict() for e in tp.events_at(t)]
                == [e.to_dict() for e in jp.events_at(t)])


@pytest.mark.parametrize("spec", SPECS)
def test_plan_json_both_ways(spec, tmp_path):
    jp, tp = JE.FaultPlan.parse(spec, 6, 2), TE.FaultPlan.parse(spec, 6, 2)
    assert tp.to_json() == jp.to_json()
    assert _events(TE.FaultPlan.from_json(jp.to_json())) == _events(jp)
    path = tmp_path / "plan.json"
    path.write_text(tp.to_json())
    assert _events(JE.FaultPlan.parse(f"@{path}", 6)) == _events(tp)
    assert _events(TE.FaultPlan.parse(f"@{path}", 6)) == _events(tp)


@pytest.mark.parametrize("spec", BAD)
def test_plan_validation_messages(spec):
    with pytest.raises(ValueError) as want:
        JE.FaultPlan.parse(spec, 2)
    with pytest.raises(ValueError) as got:
        TE.FaultPlan.parse(spec, 2)
    assert str(got.value) == str(want.value)


def test_plan_ps_outage_target():
    for spec in ("ps_outage@0:2", "ps_outage@1:1-4; ps_outage@2:0x0.5"):
        try:
            jp = JE.FaultPlan.parse(spec, 4, n_ps=2)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                TE.FaultPlan.parse(spec, 4, n_ps=2)
            assert str(got.value) == str(e)
            continue
        tp = TE.FaultPlan.parse(spec, 4, n_ps=2)
        assert _events(tp) == _events(jp)
        for t in range(6):
            _state_equal(tp.state_at(t), jp.state_at(t))


@pytest.mark.parametrize("seed", range(4))
def test_plan_random_same_seed_same_plan(seed):
    kw = dict(crash_prob=0.2, straggle_prob=0.2, bw_prob=0.2, max_down=2)
    jp = JE.FaultPlan.random(5, 30, seed=seed, **kw)
    tp = TE.FaultPlan.random(5, 30, seed=seed, **kw)
    assert tp.to_json() == jp.to_json() and len(tp.events) > 0
    assert tp == TE.FaultPlan.random(5, 30, seed=seed, **kw)
    assert tp.max_inactive() == jp.max_inactive() <= 2


# --------------------------------------------------------------------------
# effective link times and the cost-column bias
# --------------------------------------------------------------------------
def _states(n, n_ps=1):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(6):
        args = (rng.random(n) < 0.7, 1.0 + 4.0 * (rng.random(n) < 0.3)
                * rng.random(n), np.where(rng.random(n) < 0.3,
                                          rng.uniform(0.1, 0.9, n), 1.0),
                np.where(rng.random(n_ps) < 0.5, 0.05, 1.0))
        args[0][0] = True
        out.append((JE.ClusterState(*args), TE.ClusterState(*args)))
    out.append(tuple(cls(np.ones(n, bool), np.ones(n), np.ones(n),
                         np.ones(n_ps))
                     for cls in (JE.ClusterState, TE.ClusterState)))
    return out


def test_effective_t_exact():
    t32 = np.linspace(1e-4, 9e-4, 5).astype(np.float32)
    t2 = np.linspace(1e-4, 9e-4, 10).reshape(5, 2)
    for js, ts in _states(5, 2):
        np.testing.assert_array_equal(TE.effective_t(t2, ts),
                                      JE.effective_t(t2, js))
        if (js.ps_bw_factor != 1.0).any():
            with pytest.raises(ValueError, match="per-\\(worker, PS\\)"):
                TE.effective_t(t32, ts)
            continue
        want = JE.effective_t(t32, js)
        got = TE.effective_t(t32, ts)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if js.healthy:
            np.testing.assert_array_equal(got, t32)


@pytest.mark.parametrize("compute_s", [0.0, 0.01])
def test_cost_column_bias_exact(compute_s):
    t = np.linspace(1e-4, 4e-4, 5)
    for js, ts in _states(5):
        for cf in (None, js.compute_factor):
            want = JE.cost_column_bias(t, 74, js.active, cf, compute_s)
            got = TE.cost_column_bias(t, 74, ts.active, cf, compute_s)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)
            # a torch mask gives the same bits, as a tensor on its device
            tt = TE.cost_column_bias(torch.from_numpy(t), 74,
                                     torch.from_numpy(ts.active), cf,
                                     compute_s)
            assert tt.dtype == torch.float64
            np.testing.assert_array_equal(tt.numpy(), want)
            if js.healthy:
                np.testing.assert_array_equal(got, np.zeros(5))


# --------------------------------------------------------------------------
# mask_state
# --------------------------------------------------------------------------
def _filled_sparse(n, V, cap, L, seed):
    rng = np.random.default_rng(seed)
    js = JD.esd_sparse_init(n, V, cap, max_ids=L)
    planes = {
        "latest": rng.random((n, V)) < 0.5,
        "dirty": rng.random((n, V)) < 0.3,
        "last_access": rng.integers(0, 9, (n, V)).astype(np.int32),
        "slots": rng.integers(-1, V, js.slots.shape).astype(np.int32),
        "step": np.int32(5)}
    js = dataclasses.replace(js, **{k: jnp.asarray(v)
                                    for k, v in planes.items()})
    ts = TD.SparseEsdState(**{k: torch.as_tensor(v)
                              for k, v in planes.items()})
    return js, ts


@pytest.mark.parametrize("active", [[1, 1, 1, 1], [1, 0, 1, 1],
                                    [0, 1, 0, 1], [1, 1, 1, 0]])
def test_mask_state_sparse_exact(active):
    js, ts = _filled_sparse(4, 40, 8, 24, seed=sum(active))
    active = np.asarray(active, bool)
    want = JE.mask_state(js, jnp.asarray(active))
    for act in (active, torch.from_numpy(active)):
        got = TE.mask_state(ts, act)
        for f in ("latest", "dirty", "last_access", "slots", "step"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
            if active.all():
                assert torch.equal(getattr(got, f), getattr(ts, f))


@pytest.mark.parametrize("active", [[1, 1, 1], [1, 0, 1]])
def test_mask_state_dense_planes_exact(active):
    rng = np.random.default_rng(1)
    state = jax.tree.map(np.asarray, JD.esd_init(3, 40))
    state = dataclasses.replace(
        state, latest=rng.random((3, 40)) < 0.5,
        dirty=rng.random((3, 40)) < 0.5,
        last_access=rng.integers(0, 9, (3, 40)).astype(np.int32))
    active = np.asarray(active, bool)
    want = JE.mask_state(state, active)
    got = TE.mask_state(state, active)
    for f in ("latest", "dirty", "last_access"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("active", [[1, 1, 1], [1, 0, 1], [0, 1, 1]])
def test_mask_state_dense_engine_exact(active):
    """The port's dense ``EsdState`` (torch planes) against the
    reference's ``EsdState`` under ``jax.numpy``."""
    rng = np.random.default_rng(sum(active) + 7)
    planes = {"latest": rng.random((3, 40)) < 0.5,
              "dirty": rng.random((3, 40)) < 0.5,
              "last_access": rng.integers(0, 9, (3, 40)).astype(np.int32),
              "step": np.int32(4)}
    js = JD.EsdState(**{k: jnp.asarray(v) for k, v in planes.items()})
    ts = TD.EsdState(**{k: torch.as_tensor(v) for k, v in planes.items()})
    active = np.asarray(active, bool)
    want = JE.mask_state(js, jnp.asarray(active))
    for act in (active, torch.from_numpy(active)):
        got = TE.mask_state(ts, act)
        assert type(got) is TD.EsdState
        for f in ("latest", "dirty", "last_access", "step"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
            if active.all():
                assert torch.equal(getattr(got, f), getattr(ts, f))


# --------------------------------------------------------------------------
# crash, departure and rejoin handoffs on both cache engines
# --------------------------------------------------------------------------
def _planes_equal(tc, jc):
    for f in ("present", "latest", "dirty", "freq"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f),
                                      err_msg=f)


def _hp_equal(th, jh):
    assert (th.kind, th.worker, th.rows, th.wire_rows) == (
        jh.kind, jh.worker, jh.rows, jh.wire_rows)
    np.testing.assert_array_equal(th.link_rows, jh.link_rows)
    np.testing.assert_array_equal(th.link_bytes(), jh.link_bytes())
    assert th.payload_bytes == jh.payload_bytes


@pytest.mark.parametrize("engine", ["ClusterCache", "SparseClusterCache"])
@pytest.mark.parametrize("graceful,warm", [(True, True), (False, True),
                                           (True, False)])
def test_crash_and_handoffs_exact(engine, graceful, warm):
    n, V, cap = 4, 80, 40
    rng = np.random.default_rng(7)
    jc, tc = getattr(JC, engine)(n, V, cap), getattr(TC, engine)(n, V, cap)

    def step(active):
        b = [rng.integers(0, V, 6) if a else np.zeros(0, np.int64)
             for a in active]
        sj, st = jc.step([x.copy() for x in b]), tc.step([x.copy() for x in b])
        for f in ("miss_pull", "update_push", "evict_push", "hits"):
            np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))

    for _ in range(4):
        step([True] * n)
    active = np.array([True, False, True, True])
    outs = jc.crash(1, graceful=graceful), tc.crash(1, graceful=graceful)
    for key in ("flushed", "inventory"):
        np.testing.assert_array_equal(outs[1][key], outs[0][key])
    _planes_equal(tc, jc)
    if graceful:
        inv = outs[0]["inventory"]
        _hp_equal(TE.departure_handoff(tc, 1, inv, active, row_bytes=8.0),
                  JE.departure_handoff(jc, 1, inv, active, row_bytes=8.0))
        extra = np.arange(60, 72)      # ids the peers lack: rows do move
        th = TE.departure_handoff(tc, 1, extra, active, row_bytes=8.0)
        _hp_equal(th, JE.departure_handoff(jc, 1, extra, active,
                                           row_bytes=8.0))
        assert th.rows > 0
        _planes_equal(tc, jc)
    for _ in range(2):
        step(active)
    active = np.ones(n, bool)
    if warm:
        th = TE.rejoin_handoff(tc, 1, active, row_bytes=2048.0)
        _hp_equal(th, JE.rejoin_handoff(jc, 1, active, row_bytes=2048.0))
        # the departure's handoff left clean rows to seed from
        assert th.rows > 0 or not graceful
    _planes_equal(tc, jc)
    for _ in range(2):
        step(active)
    _planes_equal(tc, jc)


# --------------------------------------------------------------------------
# recovery: gap_bound and replay_dispatch
# --------------------------------------------------------------------------
def _chain(steps=5):
    cfg = DLRM_CONFIGS["wdl-tiny"]
    wl = WORKLOADS[cfg.workload]
    n, m = 4, 8
    cap = int(0.2 * wl.vocab)
    t = torch.tensor([1e-4, 2e-4, 5e-4, 1e-3], dtype=torch.float32)
    dec, adv, _, rows = make_dlrm_esd_stages(n, m, t, 1.0, exchange="ragged",
                                             capacity=cap)
    state = TD.esd_sparse_init(n, wl.vocab, cap, max_ids=rows * wl.width)
    stream = wl.stream(5, n * m)
    batches = [next(stream) for _ in range(steps)]

    def decide_fn(st, b):
        return dec(st, torch.as_tensor(b[0].astype(np.int32)))

    def advance_fn(st, b, a):
        return adv(st, torch.as_tensor(b[0].astype(np.int32)),
                   torch.as_tensor(b[1]), torch.as_tensor(b[2]), a)

    states, st = [], state
    for b in batches:
        a, _ = decide_fn(st, b)
        _, st, _ = advance_fn(st, b, a)
        states.append(st)
    return states, batches, decide_fn, advance_fn, t.numpy()


def _np_state(s):
    return JD.SparseEsdState(*(getattr(s, f.name).numpy()
                               for f in dataclasses.fields(s)))


def test_replay_reaches_uninterrupted_state():
    states, batches, decide_fn, advance_fn, _ = _chain()
    got, assigns = TE.replay_dispatch(states[1], batches[2:], decide_fn,
                                      advance_fn)
    want, want_assigns = JE.replay_dispatch(states[1], batches[2:],
                                            decide_fn, advance_fn)
    assert len(assigns) == len(want_assigns) == 3
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(states[-1], f.name))
        assert torch.equal(getattr(got, f.name), getattr(want, f.name))
    for a, b in zip(assigns, want_assigns):
        assert torch.equal(a, b)


def test_gap_bound_exact():
    states, batches, _, _, t_np = _chain()
    samples = batches[-1][0]
    for snap, now in ((states[1], states[-1]), (states[0], states[3]),
                      (states[-1], states[-1])):
        got = TE.gap_bound(samples, snap, now, t_np)
        want = JE.gap_bound(samples, _np_state(snap), _np_state(now), t_np)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all()
    # the bound holds: deciding on the snapshot misprices by no more
    C = [torch.stack([TD.esd_cost_matrix(torch.as_tensor(
        samples.astype(np.int32)), s, torch.from_numpy(t_np))]).numpy()[0]
        for s in (states[1], states[-1])]
    bound = TE.gap_bound(samples, states[1], states[-1], t_np)
    assert (np.abs(C[0] - C[1]) <= bound[:, None] + 1e-12).all()
    assert bound.max() > 0


# --------------------------------------------------------------------------
# the cost's column bias and the elastic stages' guards
# --------------------------------------------------------------------------
def test_cost_matrix_col_bias():
    """``esd_cost_matrix(col_bias=)`` against the reference's (B1's
    Pallas kernel in interpret mode): exact, a dead worker's penalty and
    a straggler's excess included; ``None`` and an all-zero bias give
    the same bits."""
    rng = np.random.default_rng(4)
    js, ts = _filled_sparse(4, 40, 8, 24, seed=9)
    t = np.asarray([2e-4, 3e-4, 5e-4, 7e-4], np.float32)
    s = rng.integers(-1, 40, (8, 5)).astype(np.int32)
    active = np.array([True, False, True, True])
    bias = JE.cost_column_bias(t, 5, active, np.array([1.0, 1.0, 4.0, 1.0]),
                               0.01).astype(np.float32)
    want = JD.esd_cost_matrix(jnp.asarray(s), js, jnp.asarray(t),
                              use_pallas=True, col_bias=jnp.asarray(bias))
    got = TD.esd_cost_matrix(torch.from_numpy(s), ts, torch.from_numpy(t),
                             torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = TD.esd_cost_matrix(torch.from_numpy(s), ts, torch.from_numpy(t))
    zero = TD.esd_cost_matrix(torch.from_numpy(s), ts, torch.from_numpy(t),
                              torch.zeros(4))
    assert torch.equal(plain, zero)
    assert (got[:, 1] > got[:, [0, 2, 3]].max()).all()


@pytest.mark.parametrize("kw", [dict(exchange="padded", elastic=True),
                                dict(exchange="ragged", elastic=True,
                                     max_failures=4),
                                dict(exchange="ragged", elastic=True,
                                     max_failures=-1)])
def test_elastic_stage_guards(kw):
    from repro.launch.steps import make_dlrm_esd_stages as j_stages

    t = np.full(4, 1e-4, np.float32)
    with pytest.raises(ValueError) as want:
        j_stages(None, 4, 8, 40, jnp.asarray(t), 1.0, **kw)
    with pytest.raises(ValueError) as got:
        make_dlrm_esd_stages(4, 8, torch.from_numpy(t), 1.0, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("m,n,maxf", [(256, 4, 1), (8, 4, 1), (8, 4, 0),
                                      (256, 4, 2), (32, 8, 3), (6, 3, 2)])
def test_elastic_capacity_rule(m, n, maxf):
    """``out_rows`` by the reference's rule (the capacity raised to
    ceil(m / (n - max_failures)), its pow2 budget a link): the
    reference's own factory's, and 512 at wdl-s1 (m 256, n 4, one
    worker down)."""
    from repro.launch.steps import make_dlrm_esd_stages as j_stages

    t = np.full(n, 1e-4, np.float32)
    want = j_stages(None, n, m, 40, jnp.asarray(t), 1.0, exchange="ragged",
                    elastic=True, max_failures=maxf)[3]
    got = make_dlrm_esd_stages(n, m, torch.from_numpy(t), 1.0,
                               exchange="ragged", elastic=True,
                               max_failures=maxf)[3]
    assert got == want
    assert (m, n, maxf) != (256, 4, 1) or got == 512
