"""The pipelined ESD training executor.

The counterpart of the JAX package's ``pipeline/runner.py``.  One
training step is three stages,

  decide   assign_t            = decide_fn(esd_state, batch_t)
  advance  (x_t, state_t, aux) = advance_fn(state_{t-1}, batch_t, assign_t)
  train    loss_t              = train_fn(x_t)

and the decide/advance chain never reads the model, so it can run
ahead of training: with ``depth = d`` the runner keeps up to ``d - 1``
advanced steps in flight before it trains the oldest.  ``depth=1`` is
the synchronous loop.  Every stage sees the same inputs at any depth,
so the pipelined schedule gives the synchronous one's values; only the
issue order changes.  The runner only orders the calls: where the
stages run on a device, the driver puts the chain on a stream of its
own (:mod:`repro_torch.pipeline.streams`), which is what lets the host
work of decide overlap the device work of train.

At depth >= 2 a step's record is built one drain late: the drain first
issues the oldest step's train, then builds the record of the step
trained before it (the end of the run builds the rest).  So the host
waits on a loss only while the next train is already queued.  Records
keep their order and values.

``stale=True`` decides on the :class:`DoubleBuffer`'s back slot: the
decision for step t reads the state of step t-2, free of step t-1's
cache update.  Its cost may be off by a bounded amount
(``double_buffer.staleness_bound``); ``realized_cost_fn`` re-scores the
chosen assignment on the committed state, recorded as
``alg1_realized``.

``decide_ahead=A`` (A >= 1) keeps up to ``A + 1`` decisions buffered,
each made on the newest state committed at its decide time, so the
decision for step t+a is a commits stale (bounded by
``staleness_bound_chain``).  At commit ``repair_fn``, if given,
re-assigns the samples whose ids changed state since decide time, and
``realized_cost_fn`` re-scores the result.

Spans (through :func:`repro_torch.obs.trace.get_tracer`: the NOOP
tracer unless one is installed, so a traced run's records equal an
untraced one's) carry the JAX package runner's names, tracks and
``step`` args, and keep their meaning under the one-drain-late
schedule:

  * ``decide``, ``realized``, ``repair`` and ``advance`` on the
    ``decide`` track time the host's call of their stage (on a card at
    depth >= 2, its issue on the chain's stream); in the decide-ahead
    chain ``decide`` carries the step it decides for (``pulled``);
  * ``train`` on ``train/<t % depth>`` is step t's in-flight window:
    opened when the step is queued for training, closed after the host
    has its loss, so decide spans of later steps fall inside it at
    depth >= 2 and none does at depth 1;
  * ``train.sync``, nested in the window on its track, is the host's
    wait for step t's loss: the record built by ``record_fn(t, ...)``,
    which turns the loss into a float.  At depth 1 it also holds step
    t's train call, which comes just before; at depth >= 2 it does not
    hold step t+1's train call, which the drain issues first.  So a
    ``train.sync`` span joins its own step's record.

Stage contracts:
  * ``decide_fn(esd_state, batch) -> (assign, alg1_est | None)``;
  * ``advance_fn(esd_state, batch, assign) -> (train_input, new_state,
    aux)``, ``aux`` any per-step accounting handed back to ``record_fn``;
  * ``train_fn(train_input) -> loss`` owns the model and optimizer state;
  * ``realized_cost_fn(state, batch, assign) -> scalar`` (optional);
  * ``repair_fn(committed_state, decide_state, batch, assign) ->
    (assign, info_dict)`` (optional, decide-ahead only); its info
    entries (``n_reassigned``) merge into the step's record info.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional

from ..obs.trace import get_tracer
from .double_buffer import db_commit, db_init

__all__ = ["PipelinedRunner"]


class PipelinedRunner:
    def __init__(self, decide_fn: Callable, advance_fn: Callable,
                 train_fn: Callable, esd_state: Any, depth: int = 1,
                 stale: bool = False,
                 realized_cost_fn: Optional[Callable] = None,
                 decide_ahead: int = 0,
                 repair_fn: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if stale and depth < 2:
            raise ValueError("stale decisions only make sense pipelined "
                             "(depth >= 2): at depth 1 the committed state "
                             "is always available")
        if decide_ahead < 0:
            raise ValueError(f"decide_ahead must be >= 0, got {decide_ahead}")
        if decide_ahead and stale:
            raise ValueError("decide_ahead subsumes stale (the chain decides "
                             "on progressively stale states already); pick "
                             "one")
        if repair_fn is not None and not decide_ahead:
            raise ValueError("repair_fn only applies to decide-ahead chains "
                             "(decide_ahead >= 1)")
        self.decide_fn = decide_fn
        self.advance_fn = advance_fn
        self.train_fn = train_fn
        self.esd_state = esd_state
        self.depth = depth
        self.stale = stale
        self.realized_cost_fn = realized_cost_fn
        self.decide_ahead = decide_ahead
        self.repair_fn = repair_fn

    def run(self, batches: Iterable[Any], steps: Optional[int] = None,
            record_fn: Optional[Callable] = None) -> list:
        """Drive the pipeline over ``batches`` (at most ``steps`` of them).

        ``record_fn(t, loss, aux, info) -> record`` builds one output
        record per step; ``info`` carries ``alg1_est`` when the decide
        stage returns it, ``alg1_realized`` with ``realized_cost_fn`` in
        the stale and decide-ahead modes, and the repair's entries.  The
        default record is ``{"step", "loss"}``.
        """
        self._records, self._trained = [], deque()
        self._record_fn = record_fn
        self._tr = get_tracer()
        if self.decide_ahead:
            self._run_ahead(batches, steps)
        else:
            self._run(batches, steps)
        return self._records

    def _run(self, batches: Iterable[Any], steps: Optional[int]):
        tr = self._tr
        it = iter(batches)
        pending: deque = deque()
        # stale mode rotates the two-slot DoubleBuffer; exact mode keeps
        # one committed state
        db = db_init(self.esd_state) if self.stale else None
        state = self.esd_state
        t = 0
        while steps is None or t < steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            committed = db.front if self.stale else state
            decide_state = db.back if self.stale else state
            with tr.span("decide", track="decide", step=t):
                assign, alg1_est = self.decide_fn(decide_state, batch)
            info = {}
            if alg1_est is not None:
                info["alg1_est"] = alg1_est
            if self.stale and self.realized_cost_fn is not None:
                # the bounded correction: re-score the stale decision on
                # the committed state the step runs against
                with tr.span("realized", track="decide", step=t):
                    info["alg1_realized"] = self.realized_cost_fn(
                        committed, batch, assign)
            with tr.span("advance", track="decide", step=t):
                train_input, new_state, aux = self.advance_fn(
                    committed, batch, assign)
            if self.stale:
                db = db_commit(db, new_state)
            state = new_state
            pending.append(self._queued(t, train_input, aux, info))
            # keep at most depth-1 advanced steps in flight ahead of train
            while len(pending) >= self.depth:
                self._drain_one(pending)
            t += 1
        self._finish(pending)
        self.esd_state = state

    def _run_ahead(self, batches: Iterable[Any], steps: Optional[int]):
        """Decide-ahead chain: keep up to ``decide_ahead + 1`` decisions
        buffered, each made on the newest state committed at its decide
        time."""
        tr = self._tr
        it = iter(batches)
        ahead = self.decide_ahead
        pending: deque = deque()
        decided: deque = deque()   # (batch, assign, alg1_est, decide_state)
        state = self.esd_state
        exhausted = False
        pulled = 0
        t = 0
        while steps is None or t < steps:
            while (len(decided) <= ahead and not exhausted
                   and (steps is None or pulled < steps)):
                try:
                    batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                with tr.span("decide", track="decide", step=pulled):
                    assign, alg1_est = self.decide_fn(state, batch)
                decided.append((batch, assign, alg1_est, state))
                pulled += 1
            if not decided:
                break
            batch, assign, alg1_est, decide_state = decided.popleft()
            info = {}
            if alg1_est is not None:
                info["alg1_est"] = alg1_est
            if self.repair_fn is not None:
                # re-assign only the samples whose ids changed state
                # between decide time and now
                with tr.span("repair", track="decide", step=t):
                    assign, repair_info = self.repair_fn(
                        state, decide_state, batch, assign)
                info.update(repair_info)
            if self.realized_cost_fn is not None:
                with tr.span("realized", track="decide", step=t):
                    info["alg1_realized"] = self.realized_cost_fn(
                        state, batch, assign)
            with tr.span("advance", track="decide", step=t):
                train_input, state, aux = self.advance_fn(state, batch,
                                                          assign)
            pending.append(self._queued(t, train_input, aux, info))
            while len(pending) >= self.depth:
                self._drain_one(pending)
            t += 1
        self._finish(pending)
        self.esd_state = state

    def _queued(self, t, train_input, aux, info) -> tuple:
        """Step t enters the queue for training: open its window."""
        window = self._tr.start_span("train", track=f"train/{t % self.depth}",
                                     step=t)
        return t, train_input, aux, info, window

    def _drain_one(self, pending: deque):
        """Train the oldest pending step; at depth >= 2 build the record
        of the step trained before it, at depth 1 its own."""
        t, train_input, aux, info, window = pending.popleft()
        if self.depth == 1:
            # the train call and the wait for its loss, as one sync
            try:
                with self._tr.span("train.sync", track=window.track, step=t):
                    self._record(t, self.train_fn(train_input), aux, info)
            finally:
                window.end()
            return
        self._trained.append((t, self.train_fn(train_input), aux, info,
                              window))
        if len(self._trained) > 1:
            self._sync_record(*self._trained.popleft())

    def _finish(self, pending: deque):
        while pending:
            self._drain_one(pending)
        while self._trained:
            self._sync_record(*self._trained.popleft())

    def _sync_record(self, t, loss, aux, info, window):
        """The wait for step t's loss, then the end of its window."""
        try:
            with self._tr.span("train.sync", track=window.track, step=t):
                self._record(t, loss, aux, info)
        finally:
            window.end()

    def _record(self, t, loss, aux, info):
        self._records.append({"step": t, "loss": float(loss)}
                             if self._record_fn is None
                             else self._record_fn(t, loss, aux, info))
