"""One writer for every ``BENCH_*.json`` artifact of the port.

All benchmarks land their results through :func:`write_bench`, which

* resolves the canonical path ``benchmarks/results_torch/BENCH_<name>.json``
  (``--quick`` runs get the ``_quick`` suffix — quick artifacts sit next
  to the full ones, same schema, smaller sweeps);
* validates the document against the shared schema
  (:mod:`repro_torch.obs.schema`) *before* anything lands on disk, so a
  bench can never publish an artifact that the schema would reject;
* writes atomically (tmp file + ``os.replace``) so an interrupted bench
  never leaves a truncated artifact behind;
* mirrors the artifact's scalar gate fields into the process metrics
  registry under ``bench.<name>.<path>`` gauges.

The JAX package's writer, with one difference: the default directory is
``benchmarks/results_torch/``, not ``benchmarks/results/``, where the JAX
package's committed artifacts live.  The port's artifacts come from runs
on a card, and that directory is not committed.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

from .metrics import get_registry
from .schema import validate_bench

__all__ = ["write_bench", "default_results_dir"]

# benchmarks/results_torch/, relative to the repo root (this file lives
# at src/repro_torch/obs/artifacts.py).
_REPO_ROOT = Path(__file__).resolve().parents[3]


def default_results_dir() -> Path:
    return _REPO_ROOT / "benchmarks" / "results_torch"


def _mirror_gauges(name: str, node, path: str) -> None:
    reg = get_registry()
    if isinstance(node, dict):
        for k, v in node.items():
            _mirror_gauges(name, v, f"{path}.{k}" if path else str(k))
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        reg.gauge(f"bench.{name}.{path}").set(node)


def write_bench(name: str, report: dict, *, quick: bool = False,
                out: Optional[str] = None,
                results_dir: Optional[str] = None) -> Path:
    """Validate ``report`` against the shared schema and write it.

    ``out`` overrides the full destination path (tests point benches at
    tmp dirs); otherwise the artifact goes to
    ``<results_dir>/BENCH_<name>[_quick].json``.  Returns the path
    written.  Raises :class:`repro_torch.obs.schema.SchemaError` without
    touching the filesystem if validation fails.
    """
    validate_bench(name, report)

    if out is not None:
        path = Path(out)
    else:
        base = Path(results_dir) if results_dir else default_results_dir()
        suffix = "_quick" if quick else ""
        path = base / f"BENCH_{name}{suffix}.json"

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(report, indent=2, sort_keys=False) + "\n")
    os.replace(tmp, path)

    _mirror_gauges(name, report, "")
    return path
