"""The readers of the program's own spans: on the tiny CPU cell (the
span metrics read, the device one does not: the CPU has no device
trace), and on a fixed run whose spans and kernels give each reading
exactly."""
import json
import time
import types

import pytest

import repro_torch.obs as T
from esdbench._tiny import CELL, write_tiny
from esdbench.harness import Run, Slice, run_cell
from esdbench.manifest import HERE, Bench

READ = Bench(HERE.parent).reader
SPAN_METRICS = ("auction_wait_ms", "decide_host_ms",
                "straggler_rows_per_step", "train_issue_ms")
ALL = SPAN_METRICS + ("decide_host_idle_ms",)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


AT = 5e5     # the slice's device clock, in us, less the host's


def _fixed(tr, clk, spread_us=0.0):
    """Steps 0-5, window from step 2, the slice on steps 3 and 4 (host
    seconds 30 to 50).  Step t: decide [10t + 2, 10t + 6] holding its
    auction wait [10t + 3, 10t + 4], at step 5 a straggler scan of 7
    rows; train.issue [10t + 7, 10t + 9] in train.sync; the record at
    10t + 9.6.  The slice's kernels are busy over host seconds [33.5,
    35] and [44, 46]; the harness's decide ranges lie 0.1 s inside the
    program's spans."""
    def at(t, name, **args):
        clk.t = t
        return tr.span(name, **args)

    for t in range(6):
        b = 10.0 * t
        d = at(b + 2, "decide", step=t)
        w = at(b + 3, "decide.auction_wait")
        clk.t = b + 4
        w.end()
        if t == 5:
            at(b + 4.5, "decide.straggler", rows=7).end()
        clk.t = b + 6
        d.end()
        s = at(b + 6.5, "train.sync", step=t)
        i = at(b + 7, "train.issue", step=t)
        clk.t = b + 9
        i.end()
        clk.t = b + 9.5
        s.end()
    run = Run({}, {"pipeline_depth": 1}, 1.0, 8, first=2)
    run.rec = {t: 10.0 * t + 9.6 for t in range(6)}
    run.t0, run.deadline = 19.6, 60.0
    ranges = [("decide", (10.0 * t + 2.1) * 1e6 + AT + spread_us * (t % 2),
               (10.0 * t + 5.9) * 1e6 + AT + spread_us * (t % 2))
              for t in (3, 4)]
    ranges.insert(1, ("train", 0.0, 1.0))
    run.slice = Slice(t0=30.0, t1=50.0, decided=[3, 4], advanced=[3, 4],
                      trained=[3, 4],
                      kernels=[("k", 33.5e6 + AT, 35e6 + AT),
                               ("k", 44e6 + AT, 45e6 + AT),
                               ("k", 45e6 + AT, 46e6 + AT)],
                      ranges=ranges, done=True)
    return run


def _read_fixed(**kw):
    clk = Clock()
    tr = T.Tracer(capacity=kw.pop("capacity", 256), clock=clk)
    with T.use_tracer(tr):
        run = _fixed(tr, clk, **kw)
        return {name: READ(name)(run) for name in ALL}


def test_readers_on_a_fixed_run():
    got = _read_fixed()
    # steady steps 2 and 5 (3 and 4 are the slice's)
    assert got["auction_wait_ms"] == pytest.approx(1000.0)
    assert got["decide_host_ms"] == pytest.approx(3000.0)
    assert got["straggler_rows_per_step"] == pytest.approx(3.5)
    assert got["train_issue_ms"] == pytest.approx(2000.0)
    # step 3: decide idle 4 - 1.5, its wait idle 1 - 0.5; step 4: 4 - 2
    # and 1 - 0: 3 s over 2 trained steps
    assert got["decide_host_idle_ms"] == pytest.approx(1500.0)


def test_idle_reader_needs_one_clock(capsys):
    assert _read_fixed(spread_us=30.0)["decide_host_idle_ms"] == \
        pytest.approx(1500.0, abs=0.05)
    got = _read_fixed(spread_us=400.0)
    assert got["decide_host_idle_ms"] is None
    assert "clock offsets spread" in capsys.readouterr().err
    assert got["auction_wait_ms"] == pytest.approx(1000.0)


def test_readers_read_nothing_when_the_ring_dropped_the_run():
    got = _read_fixed(capacity=12)
    assert all(v is None for v in got.values()), got


@pytest.mark.parametrize("tracer", [T.NOOP, types.SimpleNamespace()])
def test_readers_read_nothing_from_a_program_without_spans(tracer):
    """Installed NOOP, and a program whose tracer has no ``spans`` (the
    port before it recorded spans by default): None, no raise."""
    clk = Clock()
    run = _fixed(T.Tracer(capacity=256, clock=clk), clk)
    with T.use_tracer(tracer):
        assert all(READ(name)(run) is None for name in ALL)


def test_tiny_cell_reads_the_span_metrics(tmp_path):
    root = write_tiny(tmp_path)
    # the readers average the window's steps outside the slice: a
    # one-step slice two steps in leaves the window's first step out of
    # it at depth 2 however slowly the CPU runs
    mix = root / "mixes" / "tiny.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   trace_skip_steps=2, trace_steps=1)))
    res = run_cell(CELL, 2 ** 31 + 23, 4.0, True, root=root, here=root,
                   t_start=time.perf_counter(), device="cpu")
    assert res["correct"] is True
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert name in got, name
        assert got[name]["value"] >= 0.0
    assert got["auction_wait_ms"]["value"] > 0.0
    assert got["train_issue_ms"]["value"] > 0.0
    assert got["decide_host_ms"]["value"] > 0.0
    # the CPU's profile holds no device operation
    assert "decide_host_idle_ms" not in got
