"""Serving-simulator helpers.  Only the hot-set selection is here: the
serving driver seeds its planes with it.  The virtual-clock simulator
itself comes with the host-simulator slice of the port."""
from __future__ import annotations

import numpy as np


def _hot_set(workload, rng: np.random.Generator, warm: int,
             cap: int) -> np.ndarray:
    """The ``cap`` most frequent ids of a ``warm``-request stream head —
    what every worker's read-only plane replicates."""
    sample = workload.sample_batch(rng, warm)
    ids = sample[sample >= 0]
    uniq, cnt = np.unique(ids, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    return np.sort(uniq[order[:cap]])
