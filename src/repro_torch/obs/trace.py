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

Recording is on by default: :func:`get_tracer` returns a process-wide
:class:`Tracer` of 65,536 spans, so a span that instrumented code
records reaches a reader in the same process whether or not anything
installed a tracer.  ``set_tracer(NOOP)`` turns recording off: the
:data:`NOOP` tracer's ``span``/``start_span`` return one shared no-op
handle — no clock reads, no allocation, no state.  Neither perturbs a
computation: a span only reads the host clock, so records are bitwise
those of an untraced run.

Each span records its *parent*, the innermost span a ``span`` call (or
``with`` block) opened and has not closed on the same thread, and a
*step*, its ``step`` arg or else its parent's; so self time and the
step a span belongs to need no comparison of timestamps.  A handle from
``start_span`` outlives its call site (the runner's in-flight ``train``
window) and is never a parent.  :meth:`Tracer.spans` reads the spans
with their ids, parents and steps.

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

The JAX package's module of the same path, with three differences: the
default is the bounded recorder, not :data:`NOOP`; spans carry their
parent and step; and the Chrome export stamps ``ts`` in microseconds
since the Unix epoch.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Optional

__all__ = ["Tracer", "NOOP", "get_tracer", "set_tracer", "use_tracer",
           "traced"]


class Span:
    """Open span handle; context manager or explicit ``.end()``."""

    __slots__ = ("_tracer", "name", "track", "args", "thread", "t0", "_open",
                 "id", "parent", "step", "_stack")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: dict, push: bool):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        here = tracer._open
        self.thread = here.thread
        self._open = True
        self.id = next(tracer._ids)
        top = here.spans
        if top:
            parent = top[-1]
            self.parent = parent.id
            self.step = args.get("step", parent.step)
        else:
            self.parent = None
            self.step = args.get("step")
        if push:                 # the thread's innermost open span now
            top.append(self)
            self._stack = top
        else:
            self._stack = None
        self.t0 = tracer.clock()

    def end(self) -> None:
        self.__exit__()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if not self._open:       # idempotent: with-block + manual end
            return False
        self._open = False
        tracer = self._tracer
        t1 = tracer.clock()
        stack = self._stack
        if stack is not None:
            if stack[-1] is self:
                stack.pop()
            else:                # closed before a span opened inside it
                stack.remove(self)
        rec = (self.t0, t1, self.name, self.track, self.thread, self.args,
               self.id, self.parent, self.step)
        with tracer._lock:
            tracer._buf[tracer._n % tracer._cap] = rec
            tracer._n += 1
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

    def spans(self) -> list:
        return []

    def durations(self, top: int = 10) -> list:
        return []


NOOP = _NoopTracer()


class _Open(threading.local):
    """A thread's name and the spans it opened with ``span`` and has not
    closed, innermost last."""

    def __init__(self):
        self.thread = threading.current_thread().name
        self.spans: list = []


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
        self._open = _Open()
        self._ids = itertools.count(1)
        self.clock = clock
        self.t0 = clock()      # trace epoch: exported ts are relative to it
        self.epoch_ns = time.time_ns()      # the same instant, Unix time

    @property
    def capacity(self) -> int:
        return self._cap

    # -- recording ---------------------------------------------------------
    def span(self, name: str, track: Optional[str] = None, **args) -> Span:
        """Open a span, the parent of the spans its thread opens until it
        closes; close it with ``.end()`` or a ``with`` block."""
        return Span(self, name, track, args, True)

    def start_span(self, name: str, track: Optional[str] = None,
                   **args) -> Span:
        """Open a span whose handle outlives the call site: it takes a
        parent and a step as any span does, and is never a parent."""
        return Span(self, name, track, args, False)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring (0 until the buffer wraps)."""
        return max(0, self._n - self._cap)

    # -- reading -----------------------------------------------------------
    def _records(self) -> list:
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                return self._buf[:n]
            head = n % cap
            return self._buf[head:] + self._buf[:head]

    def events(self) -> list[dict]:
        """Recorded spans, oldest first (completion order)."""
        return [{"name": name, "track": track, "thread": thread,
                 "ts": t0 - self.t0, "dur": t1 - t0, "args": args}
                for (t0, t1, name, track, thread, args, *_)
                in self._records()]

    def spans(self) -> list[dict]:
        """:meth:`events` with each span's ``id``, its ``parent``'s id
        and its ``step`` (None where it has none)."""
        return [{"name": name, "track": track, "thread": thread,
                 "ts": t0 - self.t0, "dur": t1 - t0, "args": args,
                 "id": sid, "parent": parent, "step": step}
                for (t0, t1, name, track, thread, args, sid, parent, step)
                in self._records()]

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
        ("X") event with microsecond ``ts``/``dur``.  ``ts`` counts from
        the Unix epoch, by the (clock, ``time.time_ns()``) pair the
        tracer took at its own epoch: ``torch.profiler``'s host clock is
        the Unix clock too, so the two traces load side by side.
        """
        epoch_us = self.epoch_ns * 1e-3
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
                           "ts": round(epoch_us + ev["ts"] * 1e6, 3),
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
_DEFAULT = Tracer(capacity=65536)
_current: Any = _DEFAULT


def get_tracer():
    """The process-wide tracer (the bounded default recorder unless
    another was installed) — the only call instrumented code makes on the
    hot path."""
    return _current


def set_tracer(tracer) -> Any:
    """Install ``tracer`` (:data:`NOOP` turns recording off; None
    reinstalls the default recorder); returns the previous one so
    callers can restore it."""
    global _current
    prev = _current
    _current = _DEFAULT if tracer is None else tracer
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
