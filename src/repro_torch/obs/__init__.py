"""repro_torch.obs — the observability layer of the port.

Span tracing (:mod:`.trace`), the unified metrics registry
(:mod:`.metrics`), predicted-vs-measured timing validation
(:mod:`.validate`), the shared benchmark artifact schema
(:mod:`.schema`) and writer (:mod:`.artifacts`), plus the one
``log_step`` formatter every driver print goes through.  It exports
the JAX package's ``obs`` names, in the same order.
"""
from __future__ import annotations

import json
import sys

from .trace import (Tracer, NOOP, get_tracer, set_tracer, use_tracer,
                    traced)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, set_registry, use_registry,
                      STEP_NAMESPACE)
from .validate import validate_timing, format_report
from .schema import (Gate, SCHEMAS, SchemaError, bench_name_from_path,
                     validate_bench)
from .artifacts import write_bench, default_results_dir

__all__ = [
    "Tracer", "NOOP", "get_tracer", "set_tracer", "use_tracer", "traced",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "use_registry", "STEP_NAMESPACE",
    "validate_timing", "format_report",
    "Gate", "SCHEMAS", "SchemaError", "bench_name_from_path",
    "validate_bench", "write_bench", "default_results_dir",
    "log_step",
]

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
