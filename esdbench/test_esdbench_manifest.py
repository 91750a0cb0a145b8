"""The manifest finds every piece by name, and a later cell, mix,
metric or model kind needs only new files and entries."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from esdbench.manifest import HERE, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_piece_is_found_by_name():
    bench = Bench(HERE.parent)
    for cell in bench.data["workloads"]:
        cfg = bench.config(cell["config"])
        mix = bench.mix(cell["traffic"])
        assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
        for m in bench.per_layer(cell):
            assert callable(bench.reader(m["name"]))
        assert "setup_s" in {m["name"] for m in bench.end_to_end(cell)}


def test_names_units_and_files_keep_to_the_contract():
    data = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    metrics = data["end_to_end"] + data["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in
                                             data["workloads"]]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in data["configs"]:
        path = HERE.parent / c["file"]
        assert path.is_file() and c["file"].startswith("esdbench/")
        cfg = json.loads(path.read_text())
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "dims"))
                       for k in c["reduced"])
    for m in data["per_layer"]:
        assert m["moves"] in {e["name"] for e in data["end_to_end"]}
    assert {e["name"] for e in data["end_to_end"]} == {
        "samples_per_s", "step_ms_p95", "tx_cost_us_per_sample", "setup_s"}


def test_a_new_mix_and_metric_take_only_new_files(tmp_path):
    here = tmp_path / "esdbench"
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(HERE / sub, here / sub)
    data = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    mix = json.loads((here / "mixes" / "esd.n8b128.d2.json").read_text())
    mix.update(name="esd.n8b512.d2", batch_per_worker=512)
    (here / "mixes" / "esd.n8b512.d2.json").write_text(json.dumps(mix))
    (here / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.window_steps()))\n")
    data["workloads"].append({"name": "wdl-s1.esd.n8b512.d2",
                              "config": "wdl-s1", "traffic": "esd.n8b512.d2",
                              "chips": 1, "why": "batch scaling"})
    data["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train", "moves": "samples_per_s",
                              "workloads": ["wdl-s1.esd.n8b512.d2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = Bench(tmp_path, here)
    cell = bench.cell("wdl-s1.esd.n8b512.d2")
    assert bench.mix(cell["traffic"])["batch_per_worker"] == 512
    layer = [m["name"] for m in bench.per_layer(cell)]
    assert layer == ["steps_in_window"]

    class Fake:
        def window_steps(self):
            return [5, 6, 7]
    assert bench.reader("steps_in_window")(Fake()) == 3.0


TOY = '''"""A toy kind: the sum of a sample's rows plus a projection of
its dense features, times a head."""
import torch


def leaf_specs(cfg):
    V, E = sum(cfg["table_sizes"]), cfg["embedding_dim"]
    return [("embed", (V, E), 0.01),
            ("proj", (cfg["n_dense"], E), cfg["n_dense"] ** -0.5),
            ("head", (E, 1), E ** -0.5)]


def flops_per_sample(cfg):
    E, W = cfg["embedding_dim"], sum(cfg["bag_sizes"]) + cfg["hist_max"]
    return 2 * cfg["n_dense"] * E + W * E + E + 2 * E


def forward(P, ids, dense, cfg, mm):
    valid = ids >= 0
    rows = P["embed"][torch.where(valid, ids, 0).long()]
    rows = rows * valid[..., None].to(rows.dtype)
    return mm(rows.sum(dim=1) + mm(dense.to(rows.dtype), P["proj"]),
              P["head"])[:, 0]
'''

PROBE = '''import json, sys
import numpy as np, torch
import esdbench
from esdbench import peaks, weights
from esdbench.feed import first_batches
from esdbench.gen import record_width
from esdbench.reference.train import RefTrainer, plain_mm
cfg, mix = (json.loads(open(p).read()) for p in sys.argv[1:3])
w = weights.make_weights(cfg, 5, "cpu")
ids, dense, labels = first_batches(cfg, mix, 5, 1)[0]
tr = RefTrainer(cfg, w, np.unique(ids[ids >= 0]), 0.01, torch.float32,
                plain_mm)
loss = float(tr.step(*(torch.as_tensor(a) for a in (ids, dense, labels))))
print(json.dumps({"package": esdbench.__file__,
                  "leaves": {k: list(v.shape) for k, v in w.items()},
                  "flops": peaks.model_flops_per_sample(cfg),
                  "width": record_width(cfg), "ids": list(ids.shape),
                  "loss": loss, "grads": tr.grad_norms}))
'''


def test_a_new_kind_takes_only_new_files(tmp_path):
    """A copy of the harness with a kind of its own (``toy``: leaves,
    operations, forward pass) and a multi-hot configuration of it, and
    no other file changed: the weights, the operations, the reference's
    training step and the record's width all resolve it."""
    here = tmp_path / "esdbench"
    shutil.copytree(HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "reference" / "models" / "toy.py").write_text(TOY)
    cfg = json.loads((here / "configs" / "wdl-s1.json").read_text())
    cfg.update(name="toy", kind="toy", embedding_dim=8,
               table_sizes=[50, 30, 20], bag_sizes=[2, 1, 3])
    (here / "configs" / "toy.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "mixes" / "esd.n8b128.d2.json").read_text())
    mix.update(workers=2, batch_per_worker=8)
    (tmp_path / "mix.json").write_text(json.dumps(mix))
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(here / "configs" / "toy.json"),
         str(tmp_path / "mix.json")], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["package"].startswith(str(here))
    assert got["leaves"] == {"embed": [100, 8], "proj": [13, 8],
                             "head": [8, 1]}
    assert got["flops"] == 3.0 * (2 * 13 * 8 + 6 * 8 + 8 + 2 * 8)
    assert got["width"] == 6 and got["ids"] == [16, 6]
    assert got["loss"] > 0 and set(got["grads"]) == {"embed", "proj",
                                                     "head"}
    assert all(g > 0 for g in got["grads"].values())


PIN = '''import hashlib, json, sys
from esdbench import peaks, weights
from esdbench.feed import first_batches
from esdbench.gen import record_width
cfg, mix = (json.loads(open(p).read()) for p in sys.argv[1:3])
h = hashlib.sha256()
for batch in first_batches(cfg, mix, 2 ** 31 + 17, 3):
    for a in batch:
        h.update(a.tobytes())
print(json.dumps({"seed": 2 ** 31 + 17, "batches": 3,
                  "leaf_specs": weights.leaf_specs(cfg),
                  "model_flops_per_sample": peaks.model_flops_per_sample(cfg),
                  "record_width": record_width(cfg),
                  "stream_sha256": h.hexdigest()}))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_new_cell_takes_only_new_files(tmp_path):
    """A copy of the benchmark with a cell of a new kind over multi-hot
    records (``toy``), its configuration and its pin, each a new file or
    entry: the benchmark's own tests of its cells and of its manifest
    pass in the copy, and no file the copy had changed but
    ``BENCHMARK.json``."""
    here = tmp_path / "esdbench"
    shutil.copytree(HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    (here / "reference" / "models" / "toy.py").write_text(TOY)
    cfg = json.loads((here / "configs" / "wdl-s1.json").read_text())
    cfg.update(name="toy-mh", kind="toy", embedding_dim=8,
               table_sizes=[500, 30, 20], bag_sizes=[2, 1, 3])
    (here / "configs" / "toy-mh.json").write_text(json.dumps(cfg))
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "toy-mh", "source": "tests",
                            "file": "esdbench/configs/toy-mh.json",
                            "reduced": [], "why": "tests"})
    data["workloads"].append({"name": "toy-mh.esd.n8b128.d2",
                              "config": "toy-mh", "traffic": "esd.n8b128.d2",
                              "chips": 1, "why": "tests"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    pin = subprocess.run(
        [sys.executable, "-c", PIN, str(here / "configs" / "toy-mh.json"),
         str(here / "mixes" / "esd.n8b128.d2.json")], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert pin.returncode == 0, pin.stderr
    (here / "pins" / "toy-mh.esd.n8b128.d2.json").write_text(
        pin.stdout.splitlines()[-1])
    changed = {p for p, d in _digests(tmp_path).items()
               if p in before and before[p] != d}
    assert changed == {tmp_path.joinpath("BENCHMARK.json")
                       .relative_to(tmp_path)}
    mine = "esdbench/test_esdbench_manifest.py"
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "esdbench/test_esdbench_parity.py", mine, "--deselect",
         f"{mine}::test_a_new_cell_takes_only_new_files"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:]
    assert "test_cell_reads_as_before[toy-mh.esd.n8b128.d2] PASSED" in \
        res.stdout


def test_metric_without_a_list_follows_its_end_to_end_metric(tmp_path):
    data = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    data["per_layer"] = [{"name": "train_mfu", "unit": "%",
                          "better": "higher", "source": "device_trace",
                          "layer": "device", "moves": "samples_per_s"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = Bench(tmp_path)
    for cell in data["workloads"]:
        assert [m["name"] for m in bench.per_layer(cell)] == ["train_mfu"]


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        Bench(HERE.parent).cell("no-such-cell")
