"""repro_torch.pipeline — lookahead dispatch pipelining.

The counterpart of the JAX package's ``pipeline`` package:

  * :mod:`.window` — a sliding lookahead window over the batch stream
    and its per-id first-use / last-use metadata;
  * :mod:`.double_buffer` — the two-slot ESD state a stale decision
    reads, and the bounds on the cost error such a decision can incur;
  * :mod:`.runner` — the pipelined executor: decide and advance run up
    to ``depth - 1`` steps ahead of train, on stale states, or as a
    decide-ahead chain with a commit-time repair;
  * :mod:`.streams` — the CUDA streams that give the executor its
    overlap on a card;
  * :mod:`.prefetch` — the window-driven staging plane, pulled through
    kernel B3 while training runs (serving reuses the plane).
"""
from .double_buffer import (DoubleBuffer, changed_ids, db_commit, db_init,
                            staleness_bound, staleness_bound_chain)
from .prefetch import (PrefetchPlane, prefetch_candidates, prefetch_init,
                       prefetch_step, staged_membership)
from .runner import PipelinedRunner
from .window import LookaheadWindow, WindowMeta, window_meta

__all__ = [
    "DoubleBuffer", "db_init", "db_commit", "changed_ids",
    "staleness_bound", "staleness_bound_chain", "PipelinedRunner",
    "LookaheadWindow", "WindowMeta", "window_meta", "PrefetchPlane",
    "prefetch_init", "prefetch_candidates", "prefetch_step",
    "staged_membership",
]
