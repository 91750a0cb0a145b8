"""The observability layer: repro_torch.obs against the JAX package's
repro.obs on the CPU.

* ``STEP_NAMESPACE``: the port's equals the reference's, so the same
  records fold into the same ``snapshot()`` (records carrying the keys a
  stale, decide-ahead, lookahead or fault-plan run writes).
* The tracer, the metrics registry and its process-wide current
  registry, the histogram quantiles, the bench schema and writer, and
  ``validate_timing`` / ``format_report``: the reference's own test
  cases, each run through both packages on the same inputs, with equal
  results, errors and text.  ``default_results_dir()`` is the port's
  ``benchmarks/results_torch/``, not the reference's committed
  ``benchmarks/results/``.
* The runner's spans: with pure-Python stages the port's runner opens
  the reference runner's ``(name, track, step)`` multiset at depth 1 to
  3, stale, and decide-ahead with repair; its records are equal traced
  and untraced; the measured overlap is exactly 0 at depth 1; and under
  the one-drain-late schedule each ``train.sync`` span holds its own
  step's record (the host's wait for its loss) and each window closes
  after it.
"""
import collections
import json
import math
import os
import time

import pytest

import repro.obs as J
import repro_torch.obs as T
from repro.obs.schema import _check_gate as j_check_gate
from repro.obs.schema import _sweep_finite as j_sweep_finite
from repro.pipeline.runner import PipelinedRunner as JRunner
from repro_torch.obs.schema import _check_gate as t_check_gate
from repro_torch.obs.schema import _sweep_finite as t_sweep_finite
from repro_torch.pipeline.runner import PipelinedRunner as TRunner

PKGS = {"ref": J, "port": T}
CHECK_GATE = {"ref": j_check_gate, "port": t_check_gate}
SWEEP = {"ref": j_sweep_finite, "port": t_sweep_finite}
RUNNERS = {"ref": JRunner, "port": TRunner}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TickClock:
    """Every read moves time on by one: spans get a strict order and
    positive lengths without a wall clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def both(case):
    """``case(obs, key)`` run through both packages; asserts the results
    equal and returns the port's."""
    want, got = case(J, "ref"), case(T, "port")
    assert got == want
    return got


# ------------------------------------------------------------ exports

def test_exports_the_reference_names_in_order():
    assert T.__all__ == J.__all__
    assert len(T.__all__) == 24
    for name in T.__all__:
        assert hasattr(T, name), name


def test_step_namespace_equals_reference():
    assert T.STEP_NAMESPACE == J.STEP_NAMESPACE


# records as the drivers write them: stale (alg1_realized), decide-ahead
# (n_reassigned), lookahead (window_dedup_frac), a fault plan (n_active),
# the exchange's byte counts
NAMESPACE_RECORDS = {
    "stale": [{"loss": 0.7, "cost": 0.25, "alg1_est": 1.0,
               "alg1_realized": 1.25, "miss_pull": 10},
              {"loss": 0.6, "cost": 0.5, "alg1_est": 2.0,
               "alg1_realized": 1.5, "miss_pull": 3}],
    "decide_ahead": [{"loss": 0.7, "n_reassigned": 4, "alg1_realized": 0.5,
                      "window_dedup_frac": 0.25, "prefetch_bytes": 64},
                     {"loss": 0.5, "n_reassigned": 0, "alg1_realized": 0.75,
                      "window_dedup_frac": 0.5, "prefetch_bytes": 32}],
    "fault_plan": [{"loss": 0.7, "n_active": 4, "cost": 0.1,
                    "update_push": 2},
                   {"loss": 0.6, "n_active": 3, "cost": 0.2,
                    "evict_push": 1}],
    "exchange": [{"loss": 0.7, "wire_bytes": 1024, "payload_bytes": 900,
                  "window_dedup_frac": 0.1, "n_active": 8},
                 {"loss": 0.7, "wire_bytes": 2048, "payload_bytes": 1800,
                  "alg1_realized": None}],
}


@pytest.mark.parametrize("kind", sorted(NAMESPACE_RECORDS))
def test_record_step_snapshot_equals_reference(kind):
    def case(obs, _):
        reg = obs.MetricsRegistry()
        for i, rec in enumerate(NAMESPACE_RECORDS[kind]):
            reg.record_step(i, dict(rec))
        return reg.steps, reg.snapshot()

    steps, snap = both(case)
    assert len(steps) == len(NAMESPACE_RECORDS[kind])
    for key in NAMESPACE_RECORDS[kind][0]:
        assert T.STEP_NAMESPACE[key][0] in snap, key


# ------------------------------------------------------------- tracer

def _tracer_cases():
    def span_records_name_track_args(obs, _):
        clk = FakeClock()
        tr = obs.Tracer(capacity=8, clock=clk)
        clk.t = 1.0
        with tr.span("decide", track="decide", step=7):
            clk.t = 1.5
        (ev,) = tr.events()
        assert ev["name"] == "decide" and ev["track"] == "decide"
        assert ev["args"] == {"step": 7}
        assert ev["ts"] == 1.0 and ev["dur"] == 0.5
        return tr.events()

    def ring_drops_oldest(obs, _):
        tr = obs.Tracer(capacity=3, clock=FakeClock())
        for i in range(5):
            tr.span(f"s{i}").end()
        assert [e["name"] for e in tr.events()] == ["s2", "s3", "s4"]
        assert tr.dropped == 2
        return tr.events(), tr.dropped

    def end_is_idempotent(obs, _):
        tr = obs.Tracer(capacity=4, clock=FakeClock())
        with tr.span("a") as h:
            h.end()
        assert len(tr.events()) == 1
        return tr.events()

    def start_span_crosses_scopes(obs, _):
        clk = FakeClock()
        tr = obs.Tracer(capacity=4, clock=clk)
        h = tr.start_span("train", track="train/0", step=0)
        clk.t = 2.0
        tr.span("decide", track="decide", step=1).end()
        clk.t = 3.0
        h.end()
        assert [e["name"] for e in tr.events()] == ["decide", "train"]
        train = tr.events()[1]
        assert train["ts"] == 0.0 and train["dur"] == 3.0
        return tr.events()

    def durations_aggregate(obs, _):
        clk = FakeClock()
        tr = obs.Tracer(capacity=8, clock=clk)
        for dur in (1.0, 3.0):
            h = tr.span("x")
            clk.t += dur
            h.end()
        h = tr.span("y")
        clk.t += 10.0
        h.end()
        rows = tr.durations()
        assert rows[0]["name"] == "y" and rows[0]["total_s"] == 10.0
        assert rows[1] == {"name": "x", "count": 2, "total_s": 4.0,
                           "mean_s": 2.0, "max_s": 3.0}
        return rows

    def tracks_become_distinct_tids(obs, _):
        tr = obs.Tracer(capacity=8, clock=FakeClock())
        tr.span("a", track="t0").end()
        tr.span("b", track="t1").end()
        doc = tr.chrome_trace()
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert {m["args"]["name"] for m in meta} == {"t0", "t1"}
        assert len({m["tid"] for m in meta}) == 2
        # ts aside: the port counts it from the Unix epoch
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in doc["traceEvents"]]

    def noop_is_default_and_allocation_free(obs, key):
        # the reference's default is NOOP; the port's the bounded
        # recorder, and NOOP is installed to turn recording off
        default = obs.get_tracer()
        if key == "ref":
            assert default is obs.NOOP
        else:
            assert isinstance(default, obs.Tracer)
            assert default.enabled and default.capacity == 65536
        with obs.use_tracer(obs.NOOP):
            assert obs.get_tracer() is obs.NOOP
            assert obs.get_tracer().span("a", track="x", step=1) \
                is obs.NOOP.span("b")
        assert obs.get_tracer() is default
        assert obs.NOOP.span("a", track="x", step=1) is obs.NOOP.span("b")
        assert obs.NOOP.events() == [] and obs.NOOP.durations() == []
        return obs.NOOP.enabled

    def set_tracer_restores(obs, _):
        default = obs.get_tracer()
        tr = obs.Tracer(capacity=4)
        prev = obs.set_tracer(tr)
        try:
            assert obs.get_tracer() is tr
        finally:
            obs.set_tracer(prev)
        assert obs.get_tracer() is default
        with obs.use_tracer(obs.Tracer(capacity=4)) as t2:
            assert obs.get_tracer() is t2
        return obs.get_tracer() is default

    def traced_decorator_resolves_at_call_time(obs, _):
        @obs.traced("work", track="lib")
        def work(x):
            return x + 1

        assert work(1) == 2
        with obs.use_tracer(obs.Tracer(capacity=4, clock=FakeClock())) as tr:
            assert work(2) == 3
        (ev,) = tr.events()
        assert ev["name"] == "work" and ev["track"] == "lib"
        return tr.events()

    return {f.__name__: f for f in (
        span_records_name_track_args, ring_drops_oldest, end_is_idempotent,
        start_span_crosses_scopes, durations_aggregate,
        tracks_become_distinct_tids, noop_is_default_and_allocation_free,
        set_tracer_restores, traced_decorator_resolves_at_call_time)}


TRACER_CASES = _tracer_cases()


@pytest.mark.parametrize("name", sorted(TRACER_CASES))
def test_tracer_matches_reference(name):
    both(TRACER_CASES[name])


def test_chrome_export_matches_handwritten_oracle(tmp_path):
    """Nested spans on one track, exported by both packages, against the
    trace_event document Perfetto parses.  The reference stamps ``ts``
    from its epoch; the port from the Unix epoch, by the wall-clock
    instant it took at its own epoch."""
    def case(obs, key):
        clk = FakeClock()
        tr = obs.Tracer(capacity=8, clock=clk)
        clk.t = 1.0
        outer = tr.start_span("outer", track="main", step=0)
        clk.t = 2.0
        inner = tr.span("inner", track="main")
        clk.t = 3.0
        inner.end()
        clk.t = 4.0
        outer.end()
        path = tmp_path / key / "trace.json"
        tr.export(path)
        return json.loads(path.read_text()), tr

    pid = os.getpid()

    def oracle(thread, epoch_us):
        return {
            "traceEvents": [
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "main"}},
                {"name": "outer", "ph": "X", "cat": "repro", "pid": pid,
                 "tid": 0, "ts": round(epoch_us + 1000000.0, 3),
                 "dur": 3000000.0, "args": {"step": 0, "thread": thread}},
                {"name": "inner", "ph": "X", "cat": "repro", "pid": pid,
                 "tid": 0, "ts": round(epoch_us + 2000000.0, 3),
                 "dur": 1000000.0, "args": {"thread": thread}},
            ],
            "displayTimeUnit": "ms",
        }

    doc, tr = case(J, "ref")
    assert doc == oracle(tr.events()[0]["thread"], 0.0)
    before = time.time_ns()
    doc, tr = case(T, "port")
    assert before <= tr.epoch_ns <= time.time_ns()
    assert doc == oracle(tr.events()[0]["thread"], tr.epoch_ns * 1e-3)


def test_tracer_overhead_smoke():
    """Loose smoke, as the reference's: 20k NOOP span sites and 20k live
    spans both complete far under any per-step budget."""
    t0 = time.perf_counter()
    with T.use_tracer(T.NOOP):
        for _ in range(20_000):
            with T.get_tracer().span("hot", track="x"):
                pass
    assert time.perf_counter() - t0 < 1.0
    tr = T.Tracer(capacity=1024)
    t0 = time.perf_counter()
    with T.use_tracer(tr):
        for _ in range(20_000):
            with T.get_tracer().span("hot", track="x"):
                pass
    assert time.perf_counter() - t0 < 3.0
    assert tr.dropped == 20_000 - 1024


# ----------------------------------------------------------- registry

def _registry_cases():
    def counter_gauge_histogram(obs, _):
        reg = obs.MetricsRegistry()
        reg.counter("exchange.wire_bytes").inc(10)
        reg.counter("exchange.wire_bytes").inc(5)
        reg.gauge("elastic.n_active").set(8)
        h = reg.histogram("sim.iter_time_s", keep=True)
        h.observe(1.0)
        h.observe(3.0)
        assert reg.value("exchange.wire_bytes") == 15
        assert reg.value("elastic.n_active") == 8
        assert reg.value("sim.iter_time_s") == 2.0
        assert "elastic.n_active" in reg and "nope" not in reg
        assert reg.get("nope") is None and reg.get("elastic.n_active") is \
            reg.gauge("elastic.n_active")
        assert h.samples == [1.0, 3.0] and h.mean == 2.0
        snap = reg.snapshot()
        assert snap["sim.iter_time_s"] == {
            "kind": "histogram", "count": 2, "sum": 4.0,
            "min": 1.0, "max": 3.0, "mean": 2.0}
        assert list(snap) == sorted(snap)
        return snap

    def kind_mismatch_raises(obs, _):
        reg = obs.MetricsRegistry()
        reg.counter("x")
        msgs = []
        for make in (reg.gauge, reg.histogram):
            with pytest.raises(TypeError) as e:
                make("x")
            msgs.append(str(e.value))
        return msgs

    def record_step_folds_namespace(obs, _):
        reg = obs.MetricsRegistry()
        r0 = reg.record_step(0, {"loss": 0.5, "miss_pull": 10,
                                 "cost": 0.25, "n_active": 7})
        r1 = reg.record_step(1, {"loss": 0.4, "miss_pull": 3,
                                 "cost": 0.5, "skipped_unknown": 1})
        assert reg.steps == [r0, r1]
        assert r0 == {"step": 0, "loss": 0.5, "miss_pull": 10,
                      "cost": 0.25, "n_active": 7}
        assert reg.value("cache.miss_pull") == 13
        assert reg.value("dispatch.cost_s") == 0.75
        assert reg.value("train.loss") == 0.4
        assert reg.value("elastic.n_active") == 7
        assert "skipped_unknown" not in reg.snapshot()
        return reg.snapshot()

    def use_registry_restores(obs, _):
        outer = obs.get_registry()
        with obs.use_registry() as reg:
            assert obs.get_registry() is reg and reg is not outer
        assert obs.get_registry() is outer
        mine = obs.MetricsRegistry()
        with obs.use_registry(mine) as reg:
            assert reg is mine and obs.get_registry() is mine
        prev = obs.set_registry(None)
        try:
            assert prev is outer and obs.get_registry() is not outer
        finally:
            obs.set_registry(prev)
        return obs.get_registry() is outer

    return {f.__name__: f for f in (
        counter_gauge_histogram, kind_mismatch_raises,
        record_step_folds_namespace, use_registry_restores)}


REGISTRY_CASES = _registry_cases()


@pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
def test_registry_matches_reference(name):
    both(REGISTRY_CASES[name])


def test_registries_are_separate_per_package():
    """Each package has its own process-wide registry: installing the
    port's leaves the reference's in place."""
    ref_before = J.get_registry()
    with T.use_registry() as reg:
        assert T.get_registry() is reg
        assert J.get_registry() is ref_before


QUANTILE_CASES = {
    "numpy_interpolation": ([5.0, 1.0, 3.0, 2.0, 4.0, 9.0, 0.5],
                            (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)),
    "single_sample": ([7.25], (0.0, 0.5, 0.99, 1.0)),
    "empty": ([], (0.5,)),
}


@pytest.mark.parametrize("name", sorted(QUANTILE_CASES))
def test_histogram_quantile_matches_reference(name):
    import numpy as np

    vals, qs = QUANTILE_CASES[name]

    def case(obs, _):
        h = obs.MetricsRegistry().histogram("h", keep=True)
        for v in vals:
            h.observe(v)
        # NaN != NaN: compare the empty histogram's answers as strings
        return [repr(h.quantile(q)) for q in qs]

    got = both(case)
    if vals:
        want = [repr(float(np.quantile(vals, q))) for q in qs]
        assert [float(g) for g in got] == pytest.approx(
            [float(w) for w in want])
    else:
        assert got == ["nan"]


@pytest.mark.parametrize("bad", ["keep_false", "q_low", "q_high"])
def test_histogram_quantile_raises_as_reference(bad):
    def case(obs, _):
        h = obs.MetricsRegistry().histogram("h", keep=bad != "keep_false")
        for v in (1.0, 2.0):
            h.observe(v)
        q = {"keep_false": 0.5, "q_low": -0.01, "q_high": 1.01}[bad]
        with pytest.raises((TypeError, ValueError)) as e:
            h.quantile(q)
        return type(e.value).__name__, str(e.value)

    kind, msg = both(case)
    assert kind == ("TypeError" if bad == "keep_false" else "ValueError")
    if bad == "keep_false":
        assert "keep" in msg


def test_quantile_docstring_states_the_reference_contract():
    doc = T.Histogram.quantile.__doc__
    assert doc == J.Histogram.quantile.__doc__
    assert "keep=False" in doc and "single sample" in doc


# ---------------------------------------------------- schema + writer

def test_schemas_equal_reference():
    def gates(obs):
        return {name: [(g.path, g.op, g.value, g.required) for g in gs]
                for name, gs in obs.SCHEMAS.items()}

    assert gates(T) == gates(J)
    assert len(T.SCHEMAS) == 8


GATE_DOC = {"a": 2.0, "b": [{"v": 1.0}, {"v": 3.0}], "flag": True}
GATE_CASES = {
    "ok": (GATE_DOC, [("a", "ge", 2.0), ("a", "le", 2.0),
                      ("a", "in_range", (1.0, 3.0)), ("a", "eq", 2.0),
                      ("b[*].v", "gt", 0.0), ("flag", "is_true")]),
    "fan_out_fails": (GATE_DOC, [("b[*].v", "ge", 2.0)]),
    "missing_required": ({}, [("nope", "ge", 0.0)]),
    "missing_optional": ({}, [("nope", "ge", 0.0, False)]),
    "bool_is_not_a_number": ({"x": True}, [("x", "ge", 0.0)]),
    "not_a_list": ({"b": 1}, [("b[*].v", "gt", 0.0)]),
    "flag_false": ({"flag": False}, [("flag", "is_true")]),
    "nan_leaf": ({"x": math.nan}, [("x", "lt", 1.0)]),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_gate_checks_match_reference(name):
    doc, gates = GATE_CASES[name]

    def case(obs, key):
        errors: list = []
        for g in gates:
            CHECK_GATE[key](doc, obs.Gate(*g), errors)
        return errors

    errors = both(case)
    assert (errors == []) == (name in ("ok", "missing_optional"))


def test_sweep_finite_matches_reference():
    def case(obs, key):
        errors: list = []
        SWEEP[key]({"deep": [{"x": math.nan}], "y": {"z": math.inf},
                    "ok": [1, 2.0, None, True]}, "", errors)
        return errors

    errors = both(case)
    assert len(errors) == 2 and "deep[0].x" in errors[0]


VALIDATE_CASES = {
    "dispatch_inf": ("dispatch", {"results": [
        {"V": 1, "jit": {"sparse_ms": 1.0},
         "numpy": {"sparse_ms": float("inf")}}]}),
    "obs_all_violations": ("obs", {
        "bitwise": {"identical": False}, "overhead": {"frac": 0.5},
        "overlap": {"increases_with_depth": True},
        "trace": {"valid": True, "n_events": 3}}),
    "obs_good": ("obs", {
        "bitwise": {"identical": True}, "overhead": {"frac": 0.01},
        "overlap": {"increases_with_depth": True},
        "trace": {"valid": True, "n_events": 3}}),
    "obs_missing": ("obs", {"bitwise": {"identical": True}}),
    "pipeline_optional": ("pipeline", {
        "depth": {"speedup": 1.5},
        "prefetch_driver": {"demand_ratio": 0.2, "vs_belady": 1.0,
                            "loss_invariant": True}}),
    "unknown_bench": ("nope", {"x": [1.0, math.nan]}),
    "not_an_object": ("obs", [1, 2]),
}


@pytest.mark.parametrize("name", sorted(VALIDATE_CASES))
def test_validate_bench_matches_reference(name):
    bench, doc = VALIDATE_CASES[name]

    def case(obs, _):
        try:
            obs.validate_bench(bench, doc)
        except obs.SchemaError as e:
            return str(e)
        return None

    msg = both(case)
    assert (msg is None) == (name in ("obs_good", "pipeline_optional"))
    if name == "obs_all_violations":
        assert "bitwise.identical" in msg and "overhead.frac" in msg


@pytest.mark.parametrize("path,want", [
    ("BENCH_obs.json", "obs"), ("/a/b/BENCH_obs_quick.json", "obs"),
    ("BENCH_multips_quick.json", "multips"), ("notes.json", None)])
def test_bench_name_from_path_matches_reference(path, want):
    assert both(lambda obs, _: obs.bench_name_from_path(path)) == want


GOOD = {"bitwise": {"identical": True}, "overhead": {"frac": 0.001},
        "overlap": {"increases_with_depth": True},
        "trace": {"valid": True, "n_events": 10}}


def test_write_bench_canonical_quick_and_out_paths(tmp_path):
    def case(obs, key):
        d = tmp_path / key
        p = obs.write_bench("obs", GOOD, results_dir=d)
        q = obs.write_bench("obs", GOOD, quick=True, results_dir=d)
        o = obs.write_bench("obs", GOOD, out=d / "x.json")
        assert (p, q, o) == (d / "BENCH_obs.json", d / "BENCH_obs_quick.json",
                             d / "x.json")
        assert not list(d.glob("*.tmp"))
        return [x.read_text() for x in (p, q, o)]

    texts = both(case)
    assert json.loads(texts[0]) == GOOD


def test_write_bench_invalid_never_touches_disk(tmp_path):
    bad = {"bitwise": {"identical": False}, "overhead": {"frac": 0.9},
           "overlap": {"increases_with_depth": False},
           "trace": {"valid": False, "n_events": 0}}

    def case(obs, key):
        d = tmp_path / key
        with pytest.raises(obs.SchemaError) as e:
            obs.write_bench("obs", bad, results_dir=d)
        assert not d.exists()
        return str(e.value)

    both(case)


def test_default_results_dir_is_the_ports_own():
    got, ref = T.default_results_dir(), J.default_results_dir()
    assert got != ref
    assert got.parts[-2:] == ("benchmarks", "results_torch")
    assert ref.parts[-2:] == ("benchmarks", "results")
    assert got.parent == ref.parent
    gitignore = (got.parents[1] / ".gitignore").read_text().splitlines()
    assert "benchmarks/results_torch/" in gitignore


# -------------------------------------------------- validate_timing

def _ev(name, track, ts, dur, **args):
    return {"name": name, "track": track, "thread": "t",
            "ts": ts, "dur": dur, "args": args}


TIMING_CASES = {
    "overlap_union_of_train_windows": ([
        _ev("train", "train/0", 0.0, 2.0, step=0),
        _ev("train", "train/1", 1.5, 1.0, step=1),
        _ev("decide", "decide", 1.0, 1.0, step=1),
        _ev("decide", "decide", 3.0, 1.0, step=2),
        _ev("advance", "decide", 0.0, 5.0, step=0)], []),
    "depth1_zero_overlap": ([
        _ev("train", "train/0", 1.0, 1.0, step=0),
        _ev("decide", "decide", 0.0, 1.0, step=0),
        _ev("decide", "decide", 2.0, 1.0, step=1)], []),
    "alg1_ordering": ([], [
        {"step": 0, "alg1_est": 1.0, "alg1_realized": 1.0},
        {"step": 1, "alg1_est": 2.0, "alg1_realized": 3.0},
        {"step": 2, "alg1_est": 3.0, "alg1_realized": 2.0}]),
    "predicted_vs_wall": ([
        _ev("decide", "decide", 0.0, 0.1, step=0),
        _ev("decide", "decide", 1.0, 0.3, step=1),
        _ev("decide", "decide", 2.0, 0.2, step=2),
        _ev("train.sync", "train/0", 0.1, 0.5, step=0),
        _ev("train.sync", "train/1", 1.3, 0.4, step=1)], [
        {"step": 0, "cost": 1.0}, {"step": 1, "cost": 3.0},
        {"step": 2, "cost": 2.0}, None]),
    "format_renders": ([
        _ev("decide", "decide", 0.0, 0.1, step=0),
        _ev("train", "train/0", 0.0, 1.0, step=0)],
        [{"step": 0, "loss": 1.0}]),
    "empty": ([], []),
}


@pytest.mark.parametrize("name", sorted(TIMING_CASES))
def test_validate_timing_and_report_match_reference(name):
    events, steps = TIMING_CASES[name]
    rep, text = both(lambda obs, _: (
        obs.validate_timing(events, steps),
        obs.format_report(obs.validate_timing(events, steps))))
    assert set(rep) == {"n_events", "n_steps", "stages", "overlap", "alg1",
                        "predicted_vs_wall"}
    assert "timing validation" in text
    if name == "overlap_union_of_train_windows":
        ov = rep["overlap"]
        assert (ov["decide_total_s"], ov["decide_hidden_s"],
                ov["hidden_frac"], ov["n_train_windows"]) == (2.0, 1.0, 0.5,
                                                              2)
    if name == "depth1_zero_overlap":
        assert rep["overlap"]["hidden_frac"] == 0.0
    if name == "alg1_ordering":
        o = rep["alg1"]["ordering"]
        assert (o["concordant"], o["discordant"]) == (2, 1)
        assert o["flagged"] == [{"a": 1, "b": 2}]
    if name == "predicted_vs_wall":
        assert rep["predicted_vs_wall"]["decide"]["ordering"][
            "agreement"] == 1.0
        assert rep["predicted_vs_wall"]["train.sync"]["n"] == 2


# ----------------------------------------------------------- runner

def _stages(log, clock):
    """Pure-Python stages over integer states; each call logs itself
    with a read of the clock."""
    def decide(state, batch):
        log.append(("decide", batch, clock()))
        return batch % 3, 0.5 * batch

    def advance(state, batch, assign):
        log.append(("advance", batch, clock()))
        return (batch, assign), state + 1, {"aux": batch}

    def train(x):
        b, a = x
        log.append(("train", b, clock()))
        return math.sin(b * 1.7 + a)

    def realized(state, batch, assign):
        return 0.25 * state + assign

    def repair(committed, decided, batch, assign):
        return assign, {"n_reassigned": committed - decided}

    return decide, advance, train, realized, repair


RUNNER_SCHEDULES = {
    "depth1": dict(depth=1),
    "depth2": dict(depth=2),
    "depth3": dict(depth=3),
    "stale": dict(depth=2, stale=True, realized=True),
    "ahead_repair": dict(depth=3, decide_ahead=2, realized=True,
                         repair=True),
    "ahead_depth1": dict(depth=1, decide_ahead=1, repair=True),
}


def _run_runner(cls, sched, tracer, pkg, log=None, steps=7):
    sched = dict(sched)
    use_realized = sched.pop("realized", False)
    use_repair = sched.pop("repair", False)
    clock = tracer.clock if tracer is not None else FakeClock()
    log = [] if log is None else log
    decide, advance, train, realized, repair = _stages(log, clock)
    r = cls(decide, advance, train, 0, **sched,
            realized_cost_fn=realized if use_realized else None,
            repair_fn=repair if use_repair else None)

    def record(t, loss, aux, info):
        log.append(("record", t, clock()))
        return {"step": t, "loss": float(loss), **aux, **info}

    prev = pkg.set_tracer(tracer)
    try:
        return r.run(range(steps), record_fn=record)
    finally:
        pkg.set_tracer(prev)


def _span_multiset(tracer):
    return collections.Counter((e["name"], e["track"], e["args"].get("step"))
                               for e in tracer.events())


@pytest.mark.parametrize("name", sorted(RUNNER_SCHEDULES))
def test_runner_spans_match_reference(name):
    sched = RUNNER_SCHEDULES[name]
    spans = {}
    for key, cls in RUNNERS.items():
        tr = PKGS[key].Tracer(capacity=512, clock=TickClock())
        _run_runner(cls, sched, tr, PKGS[key])
        spans[key] = _span_multiset(tr)
    # the port's own train.issue, one a step on its window's track
    depth = sched["depth"]
    issue = collections.Counter({k: v for k, v in spans["port"].items()
                                 if k[0] == "train.issue"})
    assert issue == collections.Counter(
        ("train.issue", f"train/{t % depth}", t) for t in range(7))
    assert spans["port"] - issue == spans["ref"]
    names = {n for n, _, _ in spans["port"]}
    assert {"decide", "advance", "train", "train.sync"} <= names
    assert ("realized" in names) == bool(sched.get("realized"))
    assert ("repair" in names) == bool(sched.get("repair"))
    assert {tr for n, tr, _ in spans["port"] if n == "train"} == {
        f"train/{s}" for s in range(depth)}


@pytest.mark.parametrize("name", sorted(RUNNER_SCHEDULES))
def test_runner_records_equal_traced_and_untraced(name):
    sched = RUNNER_SCHEDULES[name]
    for key, cls in RUNNERS.items():
        base = _run_runner(cls, sched, None, PKGS[key])
        traced = _run_runner(cls, sched, PKGS[key].Tracer(capacity=512),
                             PKGS[key])
        assert base == traced
    # and the port's records equal the reference's
    assert (_run_runner(TRunner, sched, None, T)
            == _run_runner(JRunner, sched, None, J))


def test_runner_noop_tracer_is_default():
    """The default is the bounded recorder, and a run records into it."""
    default = T.get_tracer()
    assert isinstance(default, T.Tracer) and default.capacity == 65536
    first = max((e["id"] for e in default.spans()), default=0)
    recs = _run_runner(TRunner, dict(depth=2), None, T)
    assert [r["step"] for r in recs] == list(range(7))
    decides = [e["step"] for e in default.spans()
               if e["id"] > first and e["name"] == "decide"]
    assert decides == list(range(7))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_runner_sync_span_holds_its_own_record(depth):
    """Under the one-drain-late schedule, the ``train.sync`` span of step
    t holds the building of step t's record (the host's wait for its
    loss) and, at depth >= 2, not step t+1's train call; the window of
    step t closes after its sync; and the measured overlap is exactly 0
    at depth 1 and above 0 at depth >= 2."""
    tr = T.Tracer(capacity=512, clock=TickClock())
    log = []
    recs = _run_runner(TRunner, dict(depth=depth), tr, T, log=log)
    events = tr.events()
    sync = {e["args"]["step"]: e for e in events if e["name"] == "train.sync"}
    window = {e["args"]["step"]: e for e in events if e["name"] == "train"}
    assert sorted(sync) == sorted(window) == list(range(7))
    epoch = tr.t0
    for what, t, at in log:
        at -= epoch
        if what == "record":
            s = sync[t]
            assert s["ts"] < at < s["ts"] + s["dur"], (t, at, s)
        if what == "train" and depth > 1 and t >= 1:
            # step t's train call is issued before step t-1's sync opens
            assert at < sync[t - 1]["ts"]
    for t in range(7):
        s, w = sync[t], window[t]
        assert s["track"] == w["track"] == f"train/{t % depth}"
        assert w["ts"] < s["ts"] and s["ts"] + s["dur"] < w["ts"] + w["dur"]
    rep = T.validate_timing(events, recs)
    assert rep == J.validate_timing(events, recs)
    if depth == 1:
        assert rep["overlap"]["hidden_frac"] == 0.0
    else:
        assert rep["overlap"]["hidden_frac"] > 0.0
    assert rep["predicted_vs_wall"]["train.sync"] is None    # no cost


def test_runner_decide_ahead_decide_span_carries_pulled_step():
    tr = T.Tracer(capacity=512, clock=TickClock())
    _run_runner(TRunner, RUNNER_SCHEDULES["ahead_repair"], tr, T)
    decides = [e["args"]["step"] for e in tr.events()
               if e["name"] == "decide"]
    assert decides == list(range(7))
    first_advance = min(e["ts"] for e in tr.events()
                        if e["name"] == "advance")
    # decide-ahead 2: three decisions are made before the first advance
    assert sum(e["ts"] < first_advance for e in tr.events()
               if e["name"] == "decide") == 3
