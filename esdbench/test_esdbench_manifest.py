"""The manifest finds every piece by name, and a later cell, mix or
metric needs only new files and entries."""
import json
import re
import shutil

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
