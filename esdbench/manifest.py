"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them:
``configs/<config>.json``, ``mixes/<traffic>.json`` and, for each
per-layer metric the cell reports, ``metrics/<name>.py`` (a module with
``read(run) -> float | None``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Bench"]

HERE = Path(__file__).resolve().parent


class Bench:
    def __init__(self, root: Path, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for c in self.data["workloads"]:
            if c["name"] == name:
                return c
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.here / "configs" / f"{name}.json")
                          .read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.here / "mixes" / f"{name}.json")
                          .read_text())

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics the cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, name: str):
        path = self.here / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"esdbench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
