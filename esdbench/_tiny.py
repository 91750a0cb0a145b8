"""A CPU-sized cell for the benchmark's own tests: wdl-tiny (the port's
tiny workload, E 16) on 4 workers of 16 samples, written with a manifest
into a directory of its own, beside a copy of the metric readers and
the cell's pin (``test_esdbench_parity.py``)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from .manifest import HERE

__all__ = ["CELL", "LIMITS", "PIN", "write_tiny"]

CELL = "wdl-tiny.tiny"
# the tests' own limits, between the tiny cell's program readings
# (about 1e-7; decide_gap up to 0.017) and its control's (1e-6 and up)
# or the greedy decision's (decide_gap 0.087)
LIMITS = {"assign_bad": 0, "exchange_bad": 0, "counts_bad": 0,
          "alg1_gap": 1e-6, "decide_gap": 0.04, "loss_gap": 1e-6,
          "grad_gap": 1e-6, "change_gap": 1e-6}
# what the tiny cell (one id a field) reads: its leaves, operations a
# sample, record width and the sha256 of its first batches at the seed
PIN = {"seed": 2147483665, "batches": 3,
       "leaf_specs": [["embed", [4400, 16], 0.01],
                      ["bottom.0", [13, 64], 0.2773500981126146],
                      ["bottom.1", [64, 32], 0.125],
                      ["bottom.2", [32, 16], 0.1767766952966369],
                      ["top.0", [16, 64], 0.25],
                      ["top.1", [64, 32], 0.125],
                      ["top.2", [32, 1], 0.1767766952966369],
                      ["wide", [4400, 1], 0.01]],
       "model_flops_per_sample": 39330.0, "record_width": 6,
       "stream_sha256": "5ae2624faf13687f837c50e8296688b2f3a1ccf5c6eb8671"
                        "8d50ee60f5bc9461"}


def write_tiny(root: Path, depth: int = 2, codec: str | None = None,
               bag_sizes: list | None = None) -> Path:
    """The tiny cell under ``root``; ``bag_sizes``, if given, the ids a
    sample of each of its six fields."""
    root = Path(root)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "mixes").mkdir(exist_ok=True)
    shutil.copytree(HERE / "metrics", root / "metrics", dirs_exist_ok=True)
    cfg = json.loads((HERE / "configs" / "wdl-s1.json").read_text())
    cfg.update(name="wdl-tiny", program_workload="tiny", embedding_dim=16,
               mlp_dims=[64, 32], table_sizes=[2000, 2000, 100, 100, 100,
                                               100], limits=LIMITS)
    if bag_sizes is not None:
        cfg["bag_sizes"] = list(bag_sizes)
    else:
        (root / "pins").mkdir(exist_ok=True)
        (root / "pins" / f"{CELL}.json").write_text(json.dumps(PIN))
    (root / "configs" / "wdl-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "mixes" / "esd.n8b128.d2.json").read_text())
    mix.update(name="tiny", workers=4, batch_per_worker=16,
               bandwidths_gbps=[5.0, 2.0, 1.0, 0.5], pipeline_depth=depth,
               zipf_a_large=1.1, zipf_a_small=1.05, large_table_rows=1000,
               cache_ratio=0.02, warmup_steps=12, cost_steps=1,
               trace_skip_steps=0, trace_steps=2, codec=codec)
    (root / "mixes" / "tiny.json").write_text(json.dumps(mix))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "wdl-tiny", "source": "tests",
                         "file": "esdbench/configs/wdl-tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": CELL, "config": "wdl-tiny",
                           "traffic": "tiny", "chips": 1, "why": "tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
