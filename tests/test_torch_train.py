"""The port's training driver on the CPU: the entry point runs, logs
finite losses, defaults to the card, refuses what the reference's
driver refuses (with its messages) and raises on what it does not
carry yet.  Its parity with the JAX package is in
``test_torch_train_slice.py``."""
import json
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
    (["--trace-out", "t.json"], "A15"), (["--validate-timing"], "A15"),
    (["--trace-buffer", "10"], "A15")])
def test_unported_flags_raise(flags, item, tmp_path, capsys):
    """The trace flags of ROADMAP A15 are ported: each runs and raises
    nothing (tests/test_torch_obs_driver.py holds what they write)."""
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    out = main(TINY + ["--esd-alpha", "1", "--device", "cpu"] + flags)
    assert out["steps"] == 3
    err = capsys.readouterr().err
    assert ("top spans" in err) == (flags[0] != "--trace-buffer")
    if flags[0] == "--trace-out":
        assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


@pytest.mark.parametrize("flags", [
    ["--esd-alpha", "1", "--n-ps", "2"],
    ["--esd-alpha", "1", "--exchange", "ragged", "--n-ps", "3",
     "--ps-layout", "hashed", "--ps-hetero"],
    ["--esd-alpha", "1", "--esd-engine", "dense"],
    ["--esd-alpha", "1", "--ps-layout", "hashed"],
    ["--n-ps", "3", "--ps-layout", "hashed"]])
def test_ps_and_dense_engine_flags_run(flags):
    """--n-ps, --ps-layout, --ps-hetero and --esd-engine dense are
    ported (A2, A4): each runs (the slice's parity with the reference is
    tests/test_torch_ps_slice.py).  Without ESD the PS-stacked tables,
    looked up with PS-linearized ids, train as the flat ones do, and
    --ps-layout with one PS changes nothing."""
    out = main(TINY + ["--device", "cpu"] + flags)
    assert out["steps"] == 3
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])
    esd = "--esd-alpha" in flags
    assert ("cost" in out["metrics"][0]) == esd
    if esd:
        assert all(r["cost"] > 0 for r in out["metrics"])
        engine = "dense" if "dense" in flags else "sparse"
        assert type(out["esd_state"]).__name__ == (
            "EsdState" if engine == "dense" else "SparseEsdState")
    if "--n-ps" not in flags:
        plain = main(TINY + ["--device", "cpu"]
                     + [f for f in flags if f not in ("--ps-layout",
                                                      "hashed")])
        assert [r["loss"] for r in out["metrics"]] == \
            [r["loss"] for r in plain["metrics"]]
    elif not esd:
        flat = main(TINY + ["--device", "cpu"])
        assert [r["loss"] for r in out["metrics"]] == \
            [r["loss"] for r in flat["metrics"]]


@pytest.mark.parametrize("flags", [
    ["--esd-alpha", "1", "--n-ps", "2", "--esd-engine", "dense"],
    ["--ps-hetero"], ["--esd-alpha", "1", "--ps-hetero"],
    ["--esd-alpha", "1", "--n-ps", "2", "--lookahead", "2", "--prefetch",
     "8"]])
def test_ps_and_dense_engine_guards(flags):
    """The reference driver's SystemExit guards, with its messages: the
    dense engine and the prefetch plane refuse --n-ps > 1, --ps-hetero
    needs it."""
    from repro.launch import train as ref_train

    with pytest.raises(SystemExit) as want:
        ref_train.main(TINY[:2] + ["--steps", "1"] + flags)
    with pytest.raises(SystemExit) as got:
        main(TINY + ["--device", "cpu"] + flags)
    assert str(got.value) == str(want.value)
    assert "--n-ps" in str(got.value)


@pytest.mark.parametrize("flags", [
    ["--fault-plan", "crash@1:0"], ["--ckpt-dir", "CKPT"], ["--resume"],
    ["--ckpt-every", "5"], ["--compute-time-s", "0.1"]])
def test_elastic_flags_run(flags, tmp_path):
    """The A10 flags, which raised until the elastic slice, run as the
    reference's (their parity is tests/test_torch_elastic_slice.py);
    ``--resume`` alone is refused with the reference's message."""
    flags = [str(tmp_path) if f == "CKPT" else f for f in flags]
    argv = TINY + ["--esd-alpha", "1", "--exchange", "ragged", "--device",
                   "cpu", "--ckpt-every", "1"] + flags
    if flags == ["--resume"]:
        with pytest.raises(SystemExit, match="--resume needs --ckpt-dir"):
            main(argv)
        return
    out = main(argv)
    assert out["steps"] == 3
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])
    if "--fault-plan" in flags:
        assert [r["n_active"] for r in out["metrics"]] == [4, 3, 3]
    if "--ckpt-dir" in flags:
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            f"ckpt_0000000{i}.npz" for i in (1, 2, 3)]


def _records(out):
    return [{k: v for k, v in r.items() if k != "wall_s"}
            for r in out["metrics"]]


@pytest.mark.parametrize("flags", [["--smoke"], ["--seq-len", "32"]])
def test_lm_flags_are_ignored_in_dlrm_mode(flags):
    """The reference reads --smoke and --seq-len only in LM mode; its
    DLRM mode ignores them, and so does the port's: the records equal
    those of the run without the flag."""
    base = TINY + ["--esd-alpha", "1", "--exchange", "ragged", "--device",
                   "cpu"]
    assert _records(main(base + flags)) == _records(main(base))


@pytest.mark.parametrize("flags", [
    [], ["--pipeline-depth", "2", "--lookahead", "2", "--prefetch", "8",
         "--prefetch-slots", "16"]])
def test_batches_drawn_on_a_loader_thread(monkeypatch, flags):
    """The host stream is drawn through PrefetchLoader (depth 2), as the
    reference draws it; the records at depth 1, and at depth 2 with
    prefetch, equal those of the stream drawn on the main thread."""
    import repro_torch.launch.train as T

    argv = TINY + ["--esd-alpha", "1", "--exchange", "ragged", "--device",
                   "cpu"] + flags
    real, made = T.PrefetchLoader, []

    def spy(it, depth=2):
        made.append(depth)
        return real(it, depth)

    monkeypatch.setattr(T, "PrefetchLoader", spy)
    threaded = _records(main(argv))
    assert made == [2]
    monkeypatch.setattr(T, "PrefetchLoader", lambda it, depth=2: iter(it))
    assert threaded == _records(main(argv))


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
    """The LM driver trains the dense, MoE, SSM and hybrid families
    (tests/test_torch_lm*.py, test_torch_ssm*.py).  It feeds tokens only,
    as the reference's, so it refuses the VLM and audio families and
    names the step they train through (tests/test_torch_vlm.py,
    test_torch_whisper.py)."""
    for arch in ("pixtral-12b", "whisper-large-v3"):
        with pytest.raises(SystemExit, match="tokens only.*make_train_step"):
            main(["--arch", arch, "--smoke", "--device", "cpu"])


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
