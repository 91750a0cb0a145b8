"""Low-overhead span tracing for the ESD stack.

A :class:`Tracer` records named wall-clock spans into a fixed-size ring
buffer (drop-oldest, no allocation growth on long runs) and exports them
as Chrome/Perfetto ``trace_event`` JSON, so a real driver run renders as
a stage timeline (decide / advance / train / prefetch / loader tracks)
in ``chrome://tracing`` or https://ui.perfetto.dev.

Spans are *thread and stream aware*: every span records the thread it
was opened on, and an explicit ``track=`` groups spans onto a logical
stream (e.g. the pipelined runner keeps one ``train/<slot>`` track per
in-flight pipeline slot, so overlapping in-flight windows never render
as bogus nesting).  In the exported trace each track becomes its own
named thread row.

The disabled path is free by construction: instrumented code fetches the
process-wide tracer via :func:`get_tracer`, which defaults to the
:data:`NOOP` tracer whose ``span``/``start_span`` return one shared
no-op handle — no clock reads, no allocation, no state, and therefore
*bitwise* no effect on any computation (there is nothing it could
perturb; the overhead is one dict-free attribute call per span site).

Usage::

    with get_tracer().span("decide", track="decide", step=t):
        assign = decide_fn(state, batch)

    h = get_tracer().start_span("train", track="train/0", step=t)
    ...  # spans can cross function boundaries
    h.end()

    @traced("exchange.compile")
    def compile_plan(...): ...

Timing semantics: a span measures host wall time between enter and exit.
On the jitted path that is *issue* time for asynchronously dispatched
stages and issue+sync time for stages that block on a concrete value —
the pipelined runner documents which of its spans mean what.

Host-side numpy, copied line for line from the JAX package's module of
the same path, so both packages give the same results from one seed.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Optional

__all__ = ["Tracer", "NOOP", "get_tracer", "set_tracer", "use_tracer",
           "traced"]


class Span:
    """Open span handle; context manager or explicit ``.end()``."""

    __slots__ = ("_tracer", "name", "track", "args", "thread", "t0", "_open")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.thread = threading.current_thread().name
        self._open = True
        self.t0 = tracer.clock()

    def end(self) -> None:
        if not self._open:       # idempotent: with-block + manual end
            return
        self._open = False
        t1 = self._tracer.clock()
        self._tracer._record(self.name, self.track, self.thread,
                             self.t0, t1, self.args)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class _NoopSpan:
    """Shared do-nothing handle: the entire disabled-tracer hot path."""

    __slots__ = ()
    name = None
    track = None

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _NoopTracer:
    """Disabled tracer: every operation is a constant-time no-op."""

    enabled = False

    def span(self, name: str, track: Optional[str] = None, **args):
        return _NOOP_SPAN

    start_span = span

    def events(self) -> list:
        return []

    def durations(self, top: int = 10) -> list:
        return []


NOOP = _NoopTracer()


class Tracer:
    """Ring-buffered span recorder (thread-safe, drop-oldest)."""

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf: list = [None] * capacity
        self._cap = capacity
        self._n = 0            # total spans ever recorded (ring write head)
        self._lock = threading.Lock()
        self.clock = clock
        self.t0 = clock()      # trace epoch: exported ts are relative to it

    # -- recording ---------------------------------------------------------
    def span(self, name: str, track: Optional[str] = None, **args) -> Span:
        """Open a span; close it with ``.end()`` or a ``with`` block."""
        return Span(self, name, track, args)

    # same call, different intent: a handle that outlives the call site
    start_span = span

    def _record(self, name, track, thread, t0, t1, args) -> None:
        with self._lock:
            self._buf[self._n % self._cap] = (t0, t1, name, track, thread,
                                              args)
            self._n += 1

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring (0 until the buffer wraps)."""
        return max(0, self._n - self._cap)

    # -- reading -----------------------------------------------------------
    def events(self) -> list[dict]:
        """Recorded spans, oldest first (completion order)."""
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                raw = self._buf[:n]
            else:
                head = n % cap
                raw = self._buf[head:] + self._buf[:head]
        return [{"name": name, "track": track, "thread": thread,
                 "ts": t0 - self.t0, "dur": t1 - t0, "args": args}
                for (t0, t1, name, track, thread, args) in raw]

    def durations(self, top: int = 10) -> list[dict]:
        """``--durations``-style aggregate: per span name, total/count/
        mean/max seconds, sorted by total descending."""
        agg: dict[str, list] = {}
        for ev in self.events():
            a = agg.setdefault(ev["name"], [0, 0.0, 0.0])
            a[0] += 1
            a[1] += ev["dur"]
            a[2] = max(a[2], ev["dur"])
        rows = [{"name": k, "count": c, "total_s": t, "mean_s": t / c,
                 "max_s": mx} for k, (c, t, mx) in agg.items()]
        rows.sort(key=lambda r: -r["total_s"])
        return rows[:top]

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document.

        Every distinct track (explicit ``track=`` or, failing that, the
        recording thread's name) becomes one integer ``tid`` with a
        ``thread_name`` metadata record, and each span is one complete
        ("X") event with microsecond ``ts``/``dur`` relative to the
        trace epoch.
        """
        pid = os.getpid()
        tids: dict[str, int] = {}
        meta, events = [], []
        for ev in self.events():
            label = ev["track"] if ev["track"] is not None else ev["thread"]
            tid = tids.get(label)
            if tid is None:
                tid = tids[label] = len(tids)
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": label}})
            args = dict(ev["args"])
            args["thread"] = ev["thread"]
            events.append({"name": ev["name"], "ph": "X", "cat": "repro",
                           "pid": pid, "tid": tid,
                           "ts": round(ev["ts"] * 1e6, 3),
                           "dur": round(ev["dur"] * 1e6, 3),
                           "args": args})
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        """Write the Chrome trace JSON (atomic tmp-rename)."""
        from pathlib import Path

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(self.chrome_trace()))
        os.replace(tmp, path)


# -- process-wide current tracer ----------------------------------------------
_current: Any = NOOP


def get_tracer():
    """The process-wide tracer (:data:`NOOP` unless something enabled
    tracing) — the only call instrumented code makes on the hot path."""
    return _current


def set_tracer(tracer) -> Any:
    """Install ``tracer`` (None resets to :data:`NOOP`); returns the
    previous one so callers can restore it."""
    global _current
    prev = _current
    _current = NOOP if tracer is None else tracer
    return prev


class use_tracer:
    """Context manager: install a tracer for the duration of a block."""

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self):
        self._prev = set_tracer(self._tracer)
        return self._tracer

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev)
        return False


def traced(name: str, track: Optional[str] = None):
    """Decorator form: wrap every call of ``fn`` in a span.  The tracer
    is resolved at call time, so decorated library functions stay free
    when tracing is disabled."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with get_tracer().span(name, track=track):
                return fn(*a, **kw)
        return wrapper
    return deco
