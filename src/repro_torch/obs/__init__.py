"""Observability: the metrics registry and the one ``log_step``
formatter every driver print goes through."""
from __future__ import annotations

import json
import sys

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "log_step"]

# Keys pinned to the front of every step line, in this order; any other
# fields follow sorted by name, so lines stay grep/diff-stable.
_HEAD_KEYS = ("step", "loss", "wall_s")


def log_step(rec: dict, stream=None) -> str:
    """Render one per-step record as a single stable-key-order JSON line
    and write it to ``stream`` (stderr by default).  Returns the line."""
    ordered = {k: rec[k] for k in _HEAD_KEYS if k in rec}
    ordered.update((k, rec[k]) for k in sorted(rec) if k not in ordered)
    line = json.dumps(ordered)
    print(line, file=stream if stream is not None else sys.stderr,
          flush=True)
    return line
