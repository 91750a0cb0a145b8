"""The port's examples against the JAX package's on the CPU.

* ``examples/quickstart_torch.py`` prints the reference example's lines,
  line for line.
* ``examples/simulate_paper_fig4_torch.py``: each scenario's runs, at a
  few iterations, give the reference's ``simulate`` results on the same
  configurations in every field that is not a wall clock; and its
  printout at those iterations equals the reference example's, run with
  the same cut.
* ``examples/train_dlrm_esd_torch.py --tiny``: the reference example
  cannot run on this tree (its driver fails, ROADMAP C-ref-1), so each
  run's cost and final loss are held against ``run_dlrm``'s records for
  the same arguments.
* Every example and ``benchmarks/obs_bench_torch.py`` default to
  ``cuda`` and raise without a card.
"""
import contextlib
import dataclasses
import importlib.util
import io
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SimConfig as JSimConfig
from repro.core import simulate as j_simulate
from repro.data.synthetic import WORKLOADS as J_WORKLOADS

ROOT = Path(__file__).resolve().parents[1]
CUT = dict(iters=3, warmup=1)
WALL_CLOCK = {"decision_time_mean", "per_iter_time", "itps",
              "pipeline.decision_stage_mean_s",
              "metrics.dispatch.decision_s", "metrics.sim.iter_time_s"}


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_quickstart_prints_the_reference_lines():
    want = _stdout(lambda: runpy.run_path(str(ROOT / "examples" /
                                              "quickstart.py")))
    got = _stdout(lambda: _load("examples/quickstart_torch.py").main(
        ["--device", "cpu"]))
    assert got.splitlines() == want.splitlines()
    assert "actual transmission cost" in got


def _same(a, b, path):
    if path in WALL_CLOCK:
        return
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            _same(a[key], b[key], f"{path}.{key}" if path else key)
    elif isinstance(a, (np.ndarray, list, tuple)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("scenario", ["paper", "hetero_ps", "ragged",
                                      "pipelined"])
def test_fig4_scenario_matches_reference(scenario):
    ex = _load("examples/simulate_paper_fig4_torch.py")
    base = dict(ex.BASE, **CUT)
    runs = ex.SCENARIOS[scenario](dict(base, device="cpu"))
    got = ex.run_all(runs)
    ref_base = dict(base, workload=J_WORKLOADS["S2"])
    ref_runs = ex.SCENARIOS[scenario](ref_base)
    assert list(ref_runs) == list(runs)
    for label, kw in ref_runs.items():
        want = j_simulate(JSimConfig(**kw))
        for f in dataclasses.fields(want):
            _same(getattr(want, f.name), getattr(got[label], f.name),
                  f.name)
    assert all(np.isfinite(r.cost) for r in got.values())


def test_fig4_printout_matches_reference_at_a_cut():
    """The reference example's source, run with its base cut to a few
    iterations, prints what the port's ``main`` prints on the same cut
    (the simulator's decision model is calibrated, so every printed
    number is deterministic)."""
    src = (ROOT / "examples" / "simulate_paper_fig4.py").read_text()
    old = "iters=40, warmup=10"
    assert src.count(old) == 1
    src = src.replace(old, f"iters={CUT['iters']}, warmup={CUT['warmup']}")
    want = _stdout(lambda: exec(compile(src, "simulate_paper_fig4.py",
                                        "exec"), {"__name__": "ref"}))
    ex = _load("examples/simulate_paper_fig4_torch.py")
    got = _stdout(lambda: ex.main(["--device", "cpu"],
                                  base=dict(ex.BASE, **CUT)))
    assert got.splitlines() == want.splitlines()


def test_train_example_tiny_matches_driver_records(capsys):
    from repro_torch.launch.train import build_parser, run_dlrm

    ex = _load("examples/train_dlrm_esd_torch.py")
    argv = ["--tiny", "--steps", "7", "--bpw", "8", "--device", "cpu"]
    runs = ex.main(argv)
    assert list(runs) == [label for label, _ in ex.RUNS]
    args = ex.build_parser().parse_args(argv)
    for label, alpha in ex.RUNS:
        recs = run_dlrm(build_parser().parse_args(
            ex.driver_argv(args, alpha)))["metrics"]
        costs = [r["cost"] for r in recs[5:]]
        losses = [r["loss"] for r in recs]
        assert runs[label] == {"cost": float(np.sum(costs)),
                               "final_loss": float(np.mean(losses[-10:]))}
        assert runs[label]["cost"] > 0
    out = capsys.readouterr().out
    assert "ESD Opt vs Heu cost reduction" in out


@pytest.mark.parametrize("rel,call", [
    ("examples/quickstart_torch.py", lambda m: m.main([])),
    ("examples/simulate_paper_fig4_torch.py", lambda m: m.main([])),
    ("examples/train_dlrm_esd_torch.py", lambda m: m.main(["--tiny"])),
    ("benchmarks/obs_bench_torch.py", lambda m: m.run(quick=True))])
def test_default_device_is_cuda_and_raises_without_a_card(rel, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = _load(rel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(mod)
