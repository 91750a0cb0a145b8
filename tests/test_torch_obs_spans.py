"""The port's bounded span recorder and the spans the training step
records into it, on the CPU.

* The process-wide default is a :class:`Tracer` of 65,536 spans: it
  drops the oldest span first and counts what it dropped; every span
  records its parent (the innermost span open on its thread) and a step
  (its own ``step`` arg or its parent's); a ``start_span`` handle is
  never a parent; ``NOOP`` can still be installed and records nothing.
* Through ``run_dlrm``'s ESD stages at depth 1 and 2: every
  ``decide.*`` span nests in its step's ``decide`` span, every
  ``advance.*`` in its ``advance``, every ``train.forward`` /
  ``backward`` / ``update`` in its step's ``train.issue``; the records
  equal a run's under ``NOOP`` bit for bit.
* ``decide.straggler``'s ``rows`` is the count of rows the auction left
  unplaced, and no such span opens when it placed every row.
"""
import collections
import threading

import numpy as np
import pytest
import torch

import repro_torch.launch.train as TT
import repro_torch.obs as T
from repro_torch.core import dispatch as D

DLRM = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker", "8",
        "--steps", "4", "--esd-alpha", "1", "--exchange", "ragged",
        "--device", "cpu"]
RECORD_KEYS = ("step", "loss", "miss_pull", "update_push", "evict_push",
               "cost", "alg1_est")


class TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_default_recorder_is_bounded():
    default = T.get_tracer()
    assert isinstance(default, T.Tracer) and default.enabled
    assert default.capacity == 65536
    # NOOP turns recording off; None reinstalls the default
    assert T.set_tracer(T.NOOP) is default
    try:
        assert T.get_tracer() is T.NOOP
    finally:
        T.set_tracer(None)
    assert T.get_tracer() is default


def test_ring_drops_oldest_and_counts_them():
    tr = T.Tracer(capacity=3, clock=TickClock())
    for i in range(5):
        with tr.span(f"s{i}", step=i):
            pass
    spans = tr.spans()
    assert [s["name"] for s in spans] == ["s2", "s3", "s4"]
    assert [s["step"] for s in spans] == [2, 3, 4]
    assert tr.dropped == 2
    # the ids count every span opened, dropped or not
    assert [s["id"] for s in spans] == [3, 4, 5]


def test_spans_record_parent_and_inherited_step():
    tr = T.Tracer(capacity=16, clock=TickClock())
    with tr.span("decide", track="decide", step=7) as outer:
        window = tr.start_span("train", track="train/0", step=6)
        with tr.span("decide.cost") as inner:
            with tr.span("leaf", step=9):
                pass
        with tr.span("decide.auction"):
            pass
        window.end()
    with tr.span("free"):
        pass
    with tr.span("after", step=1):
        pass
    by = {s["name"]: s for s in tr.spans()}
    assert by["decide"]["parent"] is None and by["decide"]["step"] == 7
    assert by["decide"]["id"] == outer.id
    # a start_span handle takes a parent and a step, and is no parent
    assert by["train"]["parent"] == outer.id and by["train"]["step"] == 6
    assert by["decide.cost"]["parent"] == outer.id
    assert by["decide.cost"]["step"] == 7
    assert by["leaf"]["parent"] == inner.id and by["leaf"]["step"] == 9
    assert by["decide.auction"]["parent"] == outer.id
    assert by["decide.auction"]["step"] == 7
    assert by["free"]["parent"] is None and by["free"]["step"] is None
    assert by["after"]["parent"] is None and by["after"]["step"] == 1
    # events() keeps the reference's keys
    assert set(tr.events()[0]) == {"name", "track", "thread", "ts", "dur",
                                   "args"}


def test_spans_closed_out_of_order_and_on_threads():
    tr = T.Tracer(capacity=32, clock=TickClock())
    a = tr.span("a", step=1)
    b = tr.span("b")
    a.end()                      # closed before the span opened inside it
    with tr.span("c"):           # b is the innermost open span
        pass
    b.end()
    seen = {}

    def worker():
        with tr.span("w"):
            pass

    with tr.span("main", step=3):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    for s in tr.spans():
        seen[s["name"]] = s
    assert seen["c"]["parent"] == seen["b"]["id"] and seen["c"]["step"] == 1
    # another thread's spans do not nest in this thread's
    assert seen["w"]["parent"] is None and seen["w"]["step"] is None
    assert seen["w"]["thread"] != seen["main"]["thread"]


def test_noop_records_nothing():
    default = T.get_tracer()
    before = default.dropped + len(default.spans())
    with T.use_tracer(T.NOOP):
        with T.get_tracer().span("x", step=1):
            pass
        assert T.get_tracer().spans() == []
    assert default.dropped + len(default.spans()) == before


def _records(summary):
    return [[r.get(k) for k in RECORD_KEYS] for r in summary["metrics"]]


@pytest.mark.parametrize("depth", [1, 2])
def test_esd_run_nests_its_spans(depth):
    argv = DLRM + ["--pipeline-depth", str(depth)]
    with T.use_tracer(T.NOOP):
        base = TT.main(argv)
    tr = T.Tracer(capacity=4096)
    with T.use_tracer(tr):
        traced = TT.main(argv)
    assert _records(traced) == _records(base)
    spans = tr.spans()
    by_id = {s["id"]: s for s in spans}
    count = collections.Counter((s["name"], s["step"]) for s in spans)
    steps = range(4)
    for t in steps:
        for name in ("decide", "decide.cost", "decide.auction",
                     "decide.auction_wait", "advance", "advance.exchange",
                     "advance.cache", "train.issue", "train.forward",
                     "train.backward", "train.update"):
            assert count[(name, t)] == 1, (name, t)
    for s in spans:
        parent = by_id.get(s["parent"])
        if s["name"].startswith("decide."):
            assert parent["name"] == "decide" and parent["step"] == s["step"]
        elif s["name"].startswith("advance."):
            assert parent["name"] == "advance"
            assert parent["step"] == s["step"]
        elif s["name"] in ("train.forward", "train.backward",
                           "train.update"):
            assert parent["name"] == "train.issue"
            assert parent["step"] == s["step"]
        elif s["name"] == "train.issue":
            # nested in its step's sync at depth 1, alone at depth >= 2
            if depth == 1:
                assert parent["name"] == "train.sync"
                assert parent["step"] == s["step"]
            else:
                assert parent is None
            assert s["args"] == {"step": s["step"]}
    assert {s["name"] for s in spans} >= {"data.wait", "data.load"}


@pytest.mark.parametrize("rounds", [1, None])
def test_straggler_span_counts_the_auctions_unplaced_rows(monkeypatch,
                                                          rounds):
    rng = np.random.default_rng(5)
    C = torch.from_numpy(rng.random((3, 32, 4)).astype(np.float32))
    real, out = D.auction_fixed, []

    def auction(C, cap):
        a = (real(C, cap) if rounds is None
             else real(C, cap, rounds_per_phase=rounds))
        out.append(a.clone())
        return a

    monkeypatch.setattr(D, "auction_fixed", auction)
    tr = T.Tracer(capacity=64)
    with T.use_tracer(tr):
        with tr.span("decide", step=4):
            assign = D.hybrid_dispatch(C, 32, 1.0)
    (a_opt,) = out
    unplaced = int((a_opt < 0).sum())
    rows = [s["args"]["rows"] for s in tr.spans()
            if s["name"] == "decide.straggler"]
    if rounds is None:
        assert unplaced == 0 and rows == []
    else:
        assert unplaced > 0 and rows == [unplaced]
        (sp,) = [s for s in tr.spans() if s["name"] == "decide.straggler"]
        assert sp["step"] == 4
    # the scan places every row within the capacity
    assert (assign >= 0).all()
    for b in range(3):
        assert torch.bincount(assign[b].long(), minlength=4).max() <= 8
