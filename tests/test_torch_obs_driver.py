"""Tracing the port's training driver and its observability benchmark on
the CPU.

* ``main`` with ``--trace-out`` and ``--validate-timing`` at wdl-tiny,
  depth 1 and 2: the records equal an untraced run's bit for bit, the
  exported Chrome trace parses with the runner's tracks and one
  ``decide``, ``advance``, ``train`` and ``train.sync`` span a step, the
  report on stderr is the reference's ``format_report`` of the
  reference's ``validate_timing`` over the same spans and records, and
  the process-wide registry's ``steps`` is the summary's ``metrics``
  object.  On the CPU no span carries ``device_ms`` (the stages run on
  one stream).
* ``--trace-buffer`` alone is accepted and traces nothing, as in the
  reference; with ``--trace-out`` the ring drops the oldest spans and
  the warning prints.
* ``run_lm`` at the smoke config with ``--trace-out``: one ``train.sync``
  span a step on ``train/0``.
* ``benchmarks/obs_bench_torch.py``'s parts with ``--device cpu``:
  ``bitwise.identical``, ``overlap.increases_with_depth`` and
  ``trace.valid``.  The 3 % overhead gate is a wall-clock claim, which a
  shared CPU cannot judge steadily; the card's run of the bench judges
  it with the schema's gate.
* ``device_ms``: the pairing the driver does on a card at depth >= 2 (the
  k-th call of a stage is step k's span), on synthetic stage times.
"""
import collections
import importlib.util
import json
from pathlib import Path

import pytest

import repro.obs as J
import repro_torch.launch.train as TT
import repro_torch.obs as T

ROOT = Path(__file__).resolve().parents[1]
DLRM = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker", "8",
        "--steps", "4", "--esd-alpha", "1", "--exchange", "ragged",
        "--device", "cpu"]
RECORD_KEYS = ("step", "loss", "miss_pull", "update_push", "evict_push",
               "cost", "alg1_est", "demand_miss_bytes", "prefetch_bytes")


@pytest.fixture
def tracers(monkeypatch):
    """Every Tracer the driver's ``main`` makes, in order."""
    made = []

    class Recording(T.Tracer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(TT, "Tracer", Recording)
    return made


def _chrome(path) -> dict:
    doc = json.loads(Path(path).read_text())
    assert isinstance(doc, dict) and isinstance(doc["traceEvents"], list)
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "M")
        if ev["ph"] == "X":
            assert all(k in ev for k in ("name", "ts", "dur", "pid", "tid"))
    return doc


def _records(summary):
    return [[r.get(k) for k in RECORD_KEYS] for r in summary["metrics"]]


@pytest.mark.parametrize("depth", [1, 2])
def test_main_traces_dlrm_run(depth, tmp_path, tracers, capsys):
    argv = DLRM + ["--pipeline-depth", str(depth)]
    untraced = TT.main(argv)
    assert tracers == []
    assert T.get_tracer() is T.NOOP
    path = tmp_path / "trace.json"
    summary = TT.main(argv + ["--trace-out", str(path),
                              "--validate-timing"])
    err = capsys.readouterr().err
    assert T.get_tracer() is T.NOOP               # restored after the run
    assert _records(summary) == _records(untraced)
    assert T.get_registry().steps is summary["metrics"]

    (tr,) = tracers
    doc = _chrome(path)
    tracks = {ev["args"]["name"] for ev in doc["traceEvents"]
              if ev["ph"] == "M"}
    assert {"decide", "loader"} | {f"train/{s}" for s in range(depth)} \
        <= tracks
    per_step = collections.Counter(
        (ev["name"], ev["args"]["step"]) for ev in doc["traceEvents"]
        if ev["ph"] == "X" and ev["name"] in ("decide", "advance", "train",
                                              "train.sync"))
    assert per_step == {(n, t): 1 for n in ("decide", "advance", "train",
                                            "train.sync")
                        for t in range(4)}
    # the CPU runs one stream: no span carries device time
    assert not any("device_ms" in ev.get("args", {})
                   for ev in doc["traceEvents"])

    events = tr.events()
    report = T.validate_timing(events, summary["metrics"])
    want = J.validate_timing(events, summary["metrics"])
    assert report == want
    assert set(report) == {"n_events", "n_steps", "stages", "overlap",
                           "alg1", "predicted_vs_wall"}
    assert report["n_steps"] == 4
    assert report["predicted_vs_wall"]["train.sync"]["n"] == 4
    assert J.format_report(want) in err
    assert "== top spans by total wall time ==" in err
    hidden = report["overlap"]["hidden_frac"]
    assert hidden == 0.0 if depth == 1 else hidden > 0.0


def test_trace_buffer_alone_traces_nothing(tracers, capsys):
    out = TT.main(DLRM + ["--steps", "2", "--trace-buffer", "8"])
    assert out["steps"] == 2
    assert tracers == []
    assert "top spans" not in capsys.readouterr().err


def test_trace_buffer_ring_drops_oldest_and_warns(tmp_path, tracers,
                                                  capsys):
    path = tmp_path / "t.json"
    TT.main(DLRM + ["--trace-buffer", "8", "--trace-out", str(path)])
    err = capsys.readouterr().err
    (tr,) = tracers
    assert tr.dropped > 0
    assert (f"trace ring dropped {tr.dropped} oldest spans "
            f"(--trace-buffer 8)") in err
    doc = _chrome(path)
    assert sum(ev["ph"] == "X" for ev in doc["traceEvents"]) == 8


def test_run_lm_traced(tmp_path, tracers, capsys):
    path = tmp_path / "lm.json"
    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "3",
            "--seq-len", "16", "--batch-per-worker", "2", "--device", "cpu"]
    untraced = TT.main(argv)
    summary = TT.main(argv + ["--trace-out", str(path),
                              "--validate-timing"])
    err = capsys.readouterr().err
    assert [r["loss"] for r in summary["metrics"]] == \
        [r["loss"] for r in untraced["metrics"]]
    assert T.get_registry().steps is summary["metrics"]
    doc = _chrome(path)
    syncs = [ev for ev in doc["traceEvents"]
             if ev["ph"] == "X" and ev["name"] == "train.sync"]
    assert [ev["args"]["step"] for ev in syncs] == [0, 1, 2]
    tids = {ev["tid"] for ev in syncs}
    names = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M"}
    assert {names[t] for t in tids} == {"train/0"}
    (tr,) = tracers
    want = J.validate_timing(tr.events(), summary["metrics"])
    assert T.validate_timing(tr.events(), summary["metrics"]) == want
    assert J.format_report(want) in err


def _bench():
    spec = importlib.util.spec_from_file_location(
        "obs_bench_torch", ROOT / "benchmarks" / "obs_bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_bench_parts_on_cpu():
    B = _bench()
    assert (B.OVERHEAD_GATE, B.MAX_ATTEMPTS, B.WARMUP) == (0.03, 4, 2)
    parts = B.bitwise_and_overlap(12, device="cpu")
    assert parts["bitwise"] == {"identical": True, "n_steps": 12}
    ov = parts["overlap"]
    assert ov["depth1_hidden_frac"] == 0.0
    assert ov["increases_with_depth"] is True
    tr = parts["trace"]
    assert tr["valid"] is True and tr["n_events"] > 0
    assert {"decide", "prefetch", "train/0", "train/1"} <= set(tr["tracks"])
    # the sections the schema judges, but for the wall-clock gate
    for gate in T.SCHEMAS["obs"]:
        if gate.path == "overhead.frac":
            continue
        section, key = gate.path.split(".")
        v = parts[section][key]
        assert v is True or v > 0, gate
    # the prefetch pull is traced on its own track, once a step
    pulls = [e for e in parts["tracer"].events()
             if e["name"] == "prefetch.pull"]
    assert [e["args"]["step"] for e in pulls] == list(range(12))
    assert {e["track"] for e in pulls} == {"prefetch"}


@pytest.mark.parametrize("sched", [dict(depth=2), dict(depth=3,
                                                       decide_ahead=2)])
def test_device_ms_pairs_each_span_with_its_steps_stage_call(sched):
    """``device_ms`` pairing, as the driver does it on a card at depth >=
    2: the k-th call of a stage is step k's, in the decide-ahead chain
    too (decide runs for the step it pulls, ahead of the advance); only
    the run's own spans (from ``since`` on) are written, and only
    ``decide``, ``advance`` and ``train.sync``."""
    from repro_torch.pipeline.runner import PipelinedRunner

    calls = {"decide": [], "advance": [], "train": []}

    def decide(state, batch):
        calls["decide"].append(batch)
        return batch, None

    def advance(state, batch, assign):
        calls["advance"].append(batch)
        return batch, state, {}

    def train(x):
        calls["train"].append(x)
        return 0.0

    tr = T.Tracer(capacity=256)
    with T.use_tracer(tr):
        tr.span("decide", track="decide", step=0).end()   # an earlier run
        since = tr.clock() - tr.t0
        PipelinedRunner(decide, advance, train, 0, **sched).run(range(5))
    # stage s's k-th call took (100 * stage index + batch) ms
    stage_s = {s: [(100 * i + b) * 1e-3 for b in calls[s]]
               for i, s in enumerate(("decide", "advance", "train"))}
    assert all(calls[s] == list(range(5)) for s in calls)
    TT._device_ms_into_spans(tr, since, stage_s)
    events = tr.events()
    assert "device_ms" not in events[0]["args"]
    got = {}
    for ev in events[1:]:
        if "device_ms" in ev["args"]:
            got[(ev["name"], ev["args"]["step"])] = ev["args"]["device_ms"]
    want = {(n, t): pytest.approx(100 * i + t)
            for i, n in enumerate(("decide", "advance", "train.sync"))
            for t in range(5)}
    assert got == want
