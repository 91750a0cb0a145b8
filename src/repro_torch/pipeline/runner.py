"""The ESD training executor at depth 1.

The counterpart of the JAX package's ``pipeline/runner.py``, for its
synchronous schedule: one training step is three stages,

  decide   assign_t            = decide_fn(esd_state, batch_t)
  advance  (x_t, state_t, aux) = advance_fn(state_{t-1}, batch_t, assign_t)
  train    loss_t              = train_fn(x_t)

run in that order.  Running decide and advance ahead of training
(``depth >= 2``), deciding on a stale state, decide-ahead chains and
their repair come with the pipelining slice (ROADMAP A8).  The tracer
spans of the reference are not ported.

Stage contracts:
  * ``decide_fn(esd_state, batch) -> (assign, alg1_est | None)``;
  * ``advance_fn(esd_state, batch, assign) -> (train_input, new_state,
    aux)``, ``aux`` any per-step accounting handed back to ``record_fn``;
  * ``train_fn(train_input) -> loss`` owns the model and optimizer state.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

__all__ = ["PipelinedRunner"]


class PipelinedRunner:
    def __init__(self, decide_fn: Callable, advance_fn: Callable,
                 train_fn: Callable, esd_state: Any, depth: int = 1,
                 stale: bool = False, decide_ahead: int = 0,
                 repair_fn: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if depth > 1 or stale or decide_ahead or repair_fn is not None:
            raise NotImplementedError(
                "pipeline depth > 1, stale decisions, decide-ahead chains "
                "and their repair come with the pipelining slice of the "
                "port (ROADMAP A8)")
        self.decide_fn = decide_fn
        self.advance_fn = advance_fn
        self.train_fn = train_fn
        self.esd_state = esd_state

    def run(self, batches: Iterable[Any], steps: Optional[int] = None,
            record_fn: Optional[Callable] = None) -> list:
        """Drive the stages over ``batches`` (at most ``steps`` of them).

        ``record_fn(t, loss, aux, info) -> record`` builds one output
        record per step; ``info`` carries ``alg1_est`` when the decide
        stage returns it.  The default record is ``{"step", "loss"}``.
        """
        records = []
        state = self.esd_state
        for t, batch in enumerate(batches):
            if steps is not None and t >= steps:
                break
            assign, alg1_est = self.decide_fn(state, batch)
            info = {} if alg1_est is None else {"alg1_est": alg1_est}
            train_input, state, aux = self.advance_fn(state, batch, assign)
            loss = self.train_fn(train_input)
            records.append({"step": t, "loss": float(loss)}
                           if record_fn is None
                           else record_fn(t, loss, aux, info))
        self.esd_state = state
        return records
