"""The port's training driver on the CPU: the entry point runs, logs
finite losses, defaults to the card and raises on what it does not
carry yet.  Its parity with the JAX package is in
``test_torch_train_slice.py``."""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.train import build_parser, main, run_dlrm

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker", "8",
        "--steps", "3"]


def test_cli_runs_and_logs_finite_losses():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TINY,
         "--esd-alpha", "1", "--exchange", "ragged", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("{")]
    assert lines and all('"loss"' in ln for ln in lines)
    assert '"step": 2' in lines[-1]


def test_device_defaults_to_cuda_and_raises_without_a_card():
    assert build_parser().parse_args(["--arch", "wdl-tiny"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TINY + ["--esd-alpha", "1"])


@pytest.mark.parametrize("extra", [
    [], ["--esd-alpha", "0.5"], ["--esd-alpha", "1", "--exchange", "ragged",
                                 "--cap-slack", "0.5"]])
def test_runs_without_esd_and_with_other_paths(extra):
    out = run_dlrm(build_parser().parse_args(TINY + extra
                                             + ["--device", "cpu"]))
    assert out["steps"] == 3
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])
    assert ("miss_pull" in out["metrics"][0]) == bool(extra)


@pytest.mark.parametrize("flags,item", [
    (["--fault-plan", "crash@1:0"], "A10"), (["--ckpt-dir", "x"], "A10"),
    (["--resume"], "A10"), (["--n-ps", "2"], "A2"), (["--ps-hetero"], "A2"),
    (["--esd-engine", "dense"], "A4"), (["--trace-out", "t.json"], "A15"),
    (["--validate-timing"], "A15"),
    (["--ckpt-every", "5"], "A10"), (["--compute-time-s", "0.1"], "A10"),
    (["--ps-layout", "hashed"], "A2"), (["--trace-buffer", "10"], "A15"),
    (["--smoke"], "A14"), (["--seq-len", "32"], "A14")])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main(TINY + ["--esd-alpha", "1", "--device", "cpu"] + flags)


@pytest.mark.parametrize("flags", [
    ["--pipeline-depth", "2"], ["--pipeline-depth", "2", "--stale-decide"],
    ["--decide-ahead", "1"], ["--lookahead", "4"],
    ["--lookahead", "2", "--prefetch", "8"],
    ["--pipeline-depth", "2", "--lookahead", "2", "--prefetch", "8",
     "--prefetch-slots", "16"]])
def test_pipeline_flags_run(flags):
    """The six pipelining flags are ported: each runs (the slice's
    parity with the reference is tests/test_torch_pipeline_slice.py)."""
    out = main(TINY + ["--esd-alpha", "1", "--exchange", "ragged",
                       "--device", "cpu"] + flags)
    assert out["steps"] == 3 and out["wall_ms_mean"] is not None
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])
    assert ("window_dedup_frac" in out["metrics"][0]) == \
        ("--lookahead" in flags)
    assert ("alg1_realized" in out["metrics"][0]) == (
        "--stale-decide" in flags or "--decide-ahead" in flags)


@pytest.mark.parametrize("extra", [
    ["--codec", "int8"],
    ["--esd-alpha", "1", "--exchange", "ragged", "--codec", "int4:4",
     "--cap-slack", "0.5"],
    ["--esd-alpha", "1", "--exchange", "ragged", "--codec", "fp16",
     "--codec-policy", "bandwidth"]])
def test_codec_runs_on_every_loop(extra):
    out = run_dlrm(build_parser().parse_args(TINY + extra
                                             + ["--device", "cpu"]))
    assert out["steps"] == 3 and out["codec"] == extra[extra.index(
        "--codec") + 1]
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])


def test_codec_none_is_the_fp32_path():
    base = TINY + ["--esd-alpha", "1", "--exchange", "ragged", "--device",
                   "cpu"]
    a = run_dlrm(build_parser().parse_args(base))
    b = run_dlrm(build_parser().parse_args(base + ["--codec", "none"]))
    assert a["codec"] == b["codec"] == "fp32"
    for ra, rb in zip(a["metrics"], b["metrics"]):
        for key in ("loss", "cost", "miss_pull", "update_push",
                    "demand_miss_bytes"):
            assert ra[key] == rb[key], key


@pytest.mark.parametrize("flags,why", [
    (["--esd-alpha", "1", "--codec", "int8"], "needs --exchange ragged"),
    (["--codec-policy", "bandwidth"], "needs --codec")])
def test_codec_flag_guards(flags, why):
    with pytest.raises(SystemExit, match=why):
        run_dlrm(build_parser().parse_args(TINY + flags + ["--device",
                                                           "cpu"]))


def test_lm_arch_raises():
    """LM training runs the dense families (tests/test_torch_lm*.py); the
    others are still ROADMAP A14."""
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu"])


def test_realized_cost_rescores_the_decision():
    """realized_cost on the decide-time state re-scores the chosen
    assignment to the decide stage's own Alg.-1 objective."""
    import numpy as np

    from repro_torch.core.dispatch import esd_sparse_init
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.steps import make_dlrm_esd_stages

    wl = WORKLOADS["tiny"]
    t = torch.tensor([1e-4, 1e-4, 1e-3, 1e-3])
    decide, advance, realized, rows = make_dlrm_esd_stages(
        4, 8, t, 1.0, exchange="ragged", capacity=880)
    state = esd_sparse_init(4, wl.vocab, 880, max_ids=rows * wl.width)
    stream = wl.stream(3, 32)
    for _ in range(3):
        s, d, l = (torch.as_tensor(a) for a in next(stream))
        s = s.to(torch.int32)
        assign, alg1 = decide(state, s)
        torch.testing.assert_close(realized(state, s, assign), alg1,
                                   rtol=1e-6, atol=0)
        _, state, _ = advance(state, s, d, l, assign)
    assert float(alg1) > 0
