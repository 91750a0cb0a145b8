"""The check that decides ``correct``, on the CPU at a tiny cell: the
program passes; the control (the reference one precision below) and
each planted fault fail."""
import time

import pytest
import torch

from esdbench._tiny import CELL, write_tiny
from esdbench.calibrate import reading
from esdbench.faults import FAULTS, planted
from esdbench.harness import run_cell
from esdbench.manifest import Bench
from esdbench.reference.check import verdict


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = write_tiny(tmp_path_factory.mktemp("tiny"))
    bench = Bench(root, root)
    cell = bench.cell(CELL)
    return root, bench.config(cell["config"]), bench.mix(cell["traffic"])


def _run(root, trace=False, subject="program"):
    return run_cell(CELL, 2 ** 31 + 11, 2.0, trace, root=root, here=root,
                    t_start=time.perf_counter(), device="cpu",
                    subject=subject)


def test_program_run_is_correct(tiny):
    root, _, _ = tiny
    res = _run(root)
    assert res["correct"] is True
    assert list(res)[-1] == "checked"
    assert set(res["metrics"]) == {"samples_per_s", "step_ms_p95",
                                   "tx_cost_us_per_sample", "setup_s"}
    assert res["device"]["platform"] == "cpu"


def test_traced_run_reports_per_layer_metrics(tiny):
    root, _, _ = tiny
    res = _run(root, trace=True)
    assert res["correct"] is True
    assert "miss_pulls_per_sample" in res["metrics"]
    assert "samples_per_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("subject,correct", [("program", True),
                                             ("control", False)])
def test_int8_wire(tmp_path, subject, correct):
    root = write_tiny(tmp_path, codec="int8")
    assert _run(root, subject=subject)["correct"] is correct


@pytest.mark.parametrize("subject,correct", [("program", True),
                                             ("control", False)])
def test_multi_hot_records(tmp_path, subject, correct):
    """Bags of 3, 1, 2, 1, 1 and 4 ids in the six fields (12 a sample):
    the port's wdl kind over them through the run's check path."""
    root = write_tiny(tmp_path, bag_sizes=[3, 1, 2, 1, 1, 4])
    res = _run(root, subject=subject)
    assert res["correct"] is correct, res["checked"]


def test_control_is_not_correct(tiny):
    root, _, _ = tiny
    assert _run(root, subject="control")["correct"] is False


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(tiny, fault):
    _, cfg, mix = tiny
    with planted(fault):
        num = reading(cfg, mix, 7, torch.device("cpu"))
    assert not verdict(num, cfg["limits"]), num


def test_sound_readings_sit_under_the_limits(tiny):
    """The program passes, and the steps compared reach the LRU cut."""
    _, cfg, mix = tiny
    for seed in (1, 2 ** 33 + 5):
        detail = {}
        num = reading(cfg, mix, seed, torch.device("cpu"), detail=detail)
        assert verdict(num, cfg["limits"]), num
        assert detail["moved"]["evict_push"] > 0
