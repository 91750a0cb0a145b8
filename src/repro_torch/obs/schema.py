"""Shared schema for ``BENCH_*.json`` artifacts.

Every benchmark writes its artifact through
:func:`repro_torch.obs.artifacts.write_bench`, which validates against
this schema before the file lands, so an artifact can't drift shape
silently between versions.  The gates and bounds are the JAX package's
(``obs/schema.py``), copied line for line: one schema judges the
artifacts of both packages.

Validation has two parts:

* a **generic sweep**: every numeric leaf anywhere in the document must
  be finite (no NaN/Inf; benchmark gates can't be judged on garbage);
* per-benchmark **gate checks**: dotted-path assertions on the fields
  the bench's pass/fail story rests on (speedups, reductions,
  invariants).  ``[*]`` in a path fans out over list elements.  Gates
  only constrain *deterministic* quantities (simulated costs, byte
  accounting, invariant booleans) — wall-clock fields are required to
  be positive but never compared against thresholds, because CI
  machines vary.  A gate with ``required=False`` is skipped when its
  path is absent (sections that only full, non-``--quick`` runs emit).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["Gate", "SCHEMAS", "bench_name_from_path", "validate_bench",
           "SchemaError"]


class SchemaError(ValueError):
    """An artifact failed schema validation."""


@dataclass(frozen=True)
class Gate:
    path: str              # dotted path; "[*]" fans out over lists
    op: str                # ge / le / gt / lt / eq / in_range / is_true
    value: Any = None
    required: bool = True  # False: skip when the path is absent


def _resolve(doc, path: str) -> list[tuple[str, Any]]:
    """All (concrete_path, value) pairs reached by ``path``; raises
    KeyError at the first missing segment."""
    nodes = [("", doc)]
    for tok in path.split("."):
        fan = tok.endswith("[*]")
        key = tok[:-3] if fan else tok
        nxt = []
        for where, node in nodes:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"{where or '<root>'} has no field {key!r}")
            child = node[key]
            cwhere = f"{where}.{key}" if where else key
            if fan:
                if not isinstance(child, list):
                    raise KeyError(f"{cwhere} is not a list")
                nxt.extend((f"{cwhere}[{i}]", v)
                           for i, v in enumerate(child))
            else:
                nxt.append((cwhere, child))
        nodes = nxt
    return nodes


def _check_gate(doc, gate: Gate, errors: list[str]) -> None:
    try:
        nodes = _resolve(doc, gate.path)
    except KeyError as e:
        if gate.required:
            errors.append(f"missing gate field {gate.path!r}: {e}")
        return
    for where, v in nodes:
        if gate.op == "is_true":
            if v is not True:
                errors.append(f"{where} = {v!r}, expected True")
            continue
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v):
            errors.append(f"{where} = {v!r} is not a finite number")
            continue
        ok = {"ge": lambda: v >= gate.value,
              "le": lambda: v <= gate.value,
              "gt": lambda: v > gate.value,
              "lt": lambda: v < gate.value,
              "eq": lambda: v == gate.value,
              "in_range": lambda: gate.value[0] <= v <= gate.value[1],
              }[gate.op]()
        if not ok:
            errors.append(f"{where} = {v!r} fails {gate.op} {gate.value!r}")


def _sweep_finite(node, where: str, errors: list[str]) -> None:
    if isinstance(node, bool) or node is None:
        return
    if isinstance(node, (int, float)):
        if not math.isfinite(node):
            errors.append(f"{where or '<root>'} = {node!r} (non-finite)")
    elif isinstance(node, dict):
        for k, v in node.items():
            _sweep_finite(v, f"{where}.{k}" if where else str(k), errors)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _sweep_finite(v, f"{where}[{i}]", errors)


# Per-benchmark gates.  Wall-clock fields: positive only.  Deterministic
# fields (simulated costs, byte accounting, invariants): real thresholds,
# chosen to hold for both the full and --quick artifacts.
SCHEMAS: dict[str, list[Gate]] = {
    "dispatch": [
        Gate("results[*].V", "gt", 0),
        Gate("results[*].jit.sparse_ms", "gt", 0.0),
        Gate("results[*].numpy.sparse_ms", "gt", 0.0),
    ],
    "multips": [
        Gate("results[*].V", "gt", 0),
        Gate("results[*].n_ps", "ge", 1),
        Gate("results[*].sparse_ms", "gt", 0.0),
    ],
    "exchange": [
        Gate("results[*].pad_reduction", "in_range", (0.0, 1.0)),
        Gate("results[*].alg1_drop", "in_range", (0.0, 1.0)),
        Gate("results[*].ragged.wire_bytes", "gt", 0),
        Gate("codec[*].byte_reduction_int8", "ge", 4.0),
    ],
    "pipeline": [
        Gate("depth.speedup", "ge", 1.2),
        Gate("prefetch_driver.demand_ratio", "in_range", (0.0, 0.5)),
        Gate("prefetch_driver.vs_belady", "le", 1.3),
        Gate("prefetch_driver.loss_invariant", "is_true"),
        Gate("runner.bitwise_equal", "is_true", required=False),
    ],
    "elastic": [
        Gate("scenarios.oracle.itps", "gt", 0.0),
        Gate("scenarios.crash_rejoin.frac_of_oracle", "ge", 0.70),
        Gate("scenarios.crash_rejoin.tail_vs_oracle", "le", 1.10),
        Gate("scenarios.flash_crowd.min_active", "ge", 1),
    ],
    "quant": [
        Gate("results.fp32.final_loss", "in_range", (0.0, 10.0)),
        Gate("results.int8.quant.byte_reduction", "ge", 4.0),
    ],
    "serve": [
        # virtual-clock simulated latencies — deterministic given the
        # seed, so the ESD-vs-random separation gates hard
        Gate("reference.esd.slo_violation_rate", "le", 0.05),
        Gate("reference.esd_beats_random_p99", "is_true"),
        Gate("reference.esd_beats_random_slo", "is_true"),
        Gate("reference.esd.p50_ms", "gt", 0.0),
        Gate("reference.esd.p99_ms", "gt", 0.0),
        Gate("levels[*].esd.p99_ms", "gt", 0.0),
        Gate("levels[*].esd.n_requests", "gt", 0),
        Gate("levels[*].esd.qps_per_worker[*]", "ge", 0.0),
        Gate("burst.esd.p99_ms", "gt", 0.0),
        # real-clock driver smoke (full runs only): wall clock, positive
        Gate("driver.p99_ms", "gt", 0.0, required=False),
    ],
    "obs": [
        Gate("bitwise.identical", "is_true"),
        Gate("overhead.frac", "le", 0.03),
        Gate("overlap.increases_with_depth", "is_true"),
        Gate("trace.valid", "is_true"),
        Gate("trace.n_events", "gt", 0),
    ],
}

_NAME_RE = re.compile(r"^BENCH_([a-z0-9_]+?)(_quick)?\.json$")


def bench_name_from_path(path) -> Optional[str]:
    """``BENCH_<name>[_quick].json`` -> ``<name>``, else None."""
    import os
    m = _NAME_RE.match(os.path.basename(str(path)))
    return m.group(1) if m else None


def validate_bench(name: str, doc: dict) -> None:
    """Raise :class:`SchemaError` listing every violation, or return
    silently.  Unknown bench names only get the generic finite sweep."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        raise SchemaError(f"{name}: artifact root must be an object, "
                          f"got {type(doc).__name__}")
    _sweep_finite(doc, "", errors)
    for gate in SCHEMAS.get(name, []):
        _check_gate(doc, gate, errors)
    if errors:
        raise SchemaError(f"BENCH_{name}: " + "; ".join(errors))
