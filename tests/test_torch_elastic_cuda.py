"""Elastic training and resume on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_elastic_cuda.py

Without a CUDA device every test here skips.  At wdl-tiny (4 workers of
8, 6 steps, ragged exchange, alpha 1) ``run_dlrm --fault-plan`` under a
plan with a straggler, a graceful crash, a bandwidth droop and a warm
rejoin runs at depth 1 and 2 (exact and ``--codec int8``): the card's
records equal the CPU's in every integer field (cache counts and
``n_active``), with losses and Alg.-1 costs within 1e-5 (the card's
products sum in another order), and depth 2's equal depth 1's bit for
bit.  A run with ``--ckpt-every 3`` resumed from its step-3 checkpoint
gives the uninterrupted records exactly at depth 2, with the fault
tensors and the checkpoint's copies on the chain's stream; and one
resumed run goes through PyTorch's CUDA sanitizer
(``TORCH_CUDA_SANITIZER=1``), which must report no unsynchronised
access between the streams.
"""
import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.train import build_parser, main, run_dlrm
from repro_torch.models.dlrm import init_params

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
ARCH = "wdl-tiny"
PLAN = "straggle@1:0x4-3; crash@2:1g; bw@3:2x0.25-5; rejoin@3:1w"
BASE = ["--arch", ARCH, "--workers", "4", "--batch-per-worker", "8",
        "--steps", "6", "--esd-alpha", "1", "--exchange", "ragged",
        "--seed", "0", "--fault-plan", PLAN]
INTS = ("miss_pull", "update_push", "evict_push", "n_active")
KEYS = ("loss", "cost", "alg1_est") + INTS

SANITIZED = r"""
import sys
import torch
from repro_torch.launch.train import main
out = main(sys.argv[1:])
torch.cuda.synchronize()
print("SANITIZED_OK", [r["loss"] for r in out["metrics"]])
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py also runs the "
                    "elastic driver and resume on the card)")


def _run(extra, device):
    cfg = DLRM_CONFIGS[ARCH]
    model = init_params(cfg, WORKLOADS[cfg.workload],
                        torch.Generator().manual_seed(0), "cpu")
    args = build_parser().parse_args(BASE + extra + ["--device", device])
    return run_dlrm(args, model=copy.deepcopy(model).to(device))


@pytest.mark.parametrize("codec", [[], ["--codec", "int8"]],
                         ids=["exact", "int8"])
def test_elastic_driver_on_card(cuda, codec):
    one = _run(codec, "cuda")
    cpu = _run(codec, "cpu")
    assert [r["n_active"] for r in one["metrics"]] == [4, 4, 3, 4, 4, 4]
    for rc, rg in zip(cpu["metrics"], one["metrics"], strict=True):
        for key in INTS:
            assert rg[key] == rc[key], key
        for key in ("loss", "alg1_est"):
            np.testing.assert_allclose(rg[key], rc[key], rtol=1e-5)
    two = _run(codec + ["--pipeline-depth", "2"], "cuda")
    assert two["stage_clock"] == "device"
    assert [[r[k] for k in KEYS] for r in two["metrics"]] == \
        [[r[k] for k in KEYS] for r in one["metrics"]]


def test_resume_on_card(cuda, tmp_path):
    argv = BASE + ["--pipeline-depth", "2", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "3", "--codec", "int8", "--device",
                   "cuda"]
    full = main(argv)["metrics"]
    (tmp_path / "ckpt_00000006.npz").unlink()
    resumed = main(argv + ["--resume"])["metrics"]
    assert [r["step"] for r in resumed] == [3, 4, 5]
    assert [[r[k] for k in KEYS] for r in resumed] == \
        [[r[k] for k in KEYS] for r in full[3:]]
    (tmp_path / "ckpt_00000006.npz").unlink()    # the resumed run's
    env = dict(os.environ, TORCH_CUDA_SANITIZER="1",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SANITIZED, *argv,
                           "--resume"], capture_output=True, text=True,
                          timeout=900, env=env, cwd=ROOT)
    assert proc.returncode == 0 and "SANITIZED_OK" in proc.stdout, \
        proc.stderr[-6000:]
    assert "ckpt_00000006.npz" in os.listdir(tmp_path)
    assert "data race" not in proc.stderr.lower(), proc.stderr[-6000:]
