"""Checkpointed recovery of dispatch state.

The counterpart of the JAX package's ``elastic/recovery.py``.  A driver
crash loses the steps between the last ``repro_torch.checkpoint``
snapshot and the failure.  Because the decide/advance chain is a pure
function of (ESD state, batch stream) — it never reads the model
parameters — those steps are *re-derivable*: replay the deterministic
batch stream from the snapshot step and the dispatch state lands
exactly where it was (:func:`replay_dispatch`, used by tests to prove
the resumed driver's state equals the uninterrupted one).

When exact replay is not worth the work (or the stream is gone), the
resumed run may instead decide directly on the snapshot state while
training continues — a bounded-staleness start.  :func:`gap_bound`
prices that choice with the same per-id argument the stale pipeline
mode uses (``pipeline.double_buffer.staleness_bound``): only the id
columns that changed between snapshot and current state can move a
cost entry, each by at most the cluster's total per-embedding
transmission time.
"""
from __future__ import annotations

import numpy as np

from ..pipeline.double_buffer import changed_ids, staleness_bound

__all__ = ["replay_dispatch", "gap_bound"]


def replay_dispatch(state, batches, decide_fn, advance_fn):
    """Re-derive the dispatch state by replaying ``batches`` from ``state``.

    Stage contracts match
    :class:`repro_torch.pipeline.runner.PipelinedRunner`:
    ``decide_fn(state, batch) -> (assign, est)``, ``advance_fn(state,
    batch, assign) -> (train_input, new_state, aux)``.  Returns
    ``(final_state, assigns)``.
    """
    assigns = []
    for batch in batches:
        assign, _ = decide_fn(state, batch)
        _, state, _ = advance_fn(state, batch, assign)
        assigns.append(assign)
    return state, assigns


def gap_bound(samples: np.ndarray, state_snap, state_now,
              t_tran: np.ndarray, part=None) -> np.ndarray:
    """(k,) per-sample bound on the Alg.-1 cost error of deciding on the
    snapshot state instead of the (lost) current one.

    Exactly ``staleness_bound(samples, changed_ids(snap, now), t_tran)``
    — the recovery gap is a staleness gap, just wider than one step.
    """
    return staleness_bound(samples, changed_ids(state_snap, state_now),
                           t_tran, part=part)
