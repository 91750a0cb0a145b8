"""The pipelined training driver on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_pipeline_cuda.py

Without a CUDA device every test here skips.  At wdl-tiny (4 workers of
8, 5 steps, ragged exchange, alpha 1) ``run_dlrm`` runs at depth 2 and
in the decide-ahead configuration with prefetch (depth 4, lookahead 4,
decide-ahead 3, 16 rows a step into 64 slots), its chain on a stream of
its own: the depth-2 records equal the card's depth-1 records bit for
bit; both equal the CPU's in every integer field, with losses and
Alg.-1 costs within 1e-5 (the card's products sum in another order);
the plane's ids and expiry equal the CPU's.

One depth-2 run (with prefetch) goes through PyTorch's CUDA sanitizer
(``TORCH_CUDA_SANITIZER=1``) in a subprocess, which must report no
unsynchronised access of a tensor between the streams.  The sanitizer
sees PyTorch operations only: a kernel launched through ctypes (the
port's CUDA kernels) is invisible to it, so the accesses it checks are
those of the PyTorch operations around the kernels, among them every
tensor the two streams hand each other.
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
from repro_torch.launch.train import build_parser, run_dlrm
from repro_torch.models.dlrm import init_params

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
ARCH = "wdl-tiny"
BASE = ["--arch", ARCH, "--workers", "4", "--batch-per-worker", "8",
        "--steps", "5", "--esd-alpha", "1", "--exchange", "ragged",
        "--seed", "0"]
AHEAD = ["--pipeline-depth", "4", "--lookahead", "4", "--decide-ahead", "3",
         "--prefetch", "16", "--prefetch-slots", "64"]
INTS = ("miss_pull", "update_push", "evict_push", "prefetch_bytes",
        "demand_miss_bytes", "n_reassigned")

SANITIZED = r"""
import sys
import torch
from repro_torch.launch.train import build_parser, run_dlrm
out = run_dlrm(build_parser().parse_args(sys.argv[1:]))
assert out["stage_clock"] == "device", out["stage_clock"]
torch.cuda.synchronize()
print("SANITIZED_OK", [r["loss"] for r in out["metrics"]])
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py also runs the "
                    "pipelined driver on the card)")


def _run(extra, device):
    cfg = DLRM_CONFIGS[ARCH]
    model = init_params(cfg, WORKLOADS[cfg.workload],
                        torch.Generator().manual_seed(0), "cpu")
    args = build_parser().parse_args(BASE + extra + ["--device", device])
    return run_dlrm(args, model=copy.deepcopy(model).to(device))


@pytest.mark.parametrize("extra", [["--pipeline-depth", "2"], AHEAD],
                         ids=["depth2", "ahead_prefetch"])
def test_pipelined_driver_on_card(cuda, extra):
    card = _run(extra, "cuda")
    cpu = _run(extra, "cpu")
    assert card["stage_clock"] == "device" and card["wall_ms_mean"] > 0
    for rc, rg in zip(cpu["metrics"], card["metrics"], strict=True):
        assert set(rc) == set(rg)
        for key in INTS:
            assert rg.get(key) == rc.get(key), key
        for key in ("loss", "alg1_est", "alg1_realized"):
            if key in rc:
                np.testing.assert_allclose(rg[key], rc[key], rtol=1e-5)
    if card["prefetch_plane"] is not None:
        for key in ("ids", "expiry"):
            assert torch.equal(getattr(card["prefetch_plane"], key).cpu(),
                               getattr(cpu["prefetch_plane"], key))
        assert sum(r["prefetch_bytes"] for r in card["metrics"]) > 0
    if extra == AHEAD:
        return
    one = _run([], "cuda")
    keys = ("loss", "cost", "alg1_est") + INTS[:5]
    assert [[r[k] for k in keys] for r in card["metrics"]] == \
        [[r[k] for k in keys] for r in one["metrics"]]


def test_streams_pass_the_sanitizer(cuda):
    env = dict(os.environ, TORCH_CUDA_SANITIZER="1",
               PYTHONPATH=str(ROOT / "src"))
    argv = BASE + ["--pipeline-depth", "2", "--lookahead", "2",
                   "--prefetch", "16", "--prefetch-slots", "64",
                   "--steps", "3", "--device", "cuda"]
    proc = subprocess.run([sys.executable, "-c", SANITIZED, *argv],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0 and "SANITIZED_OK" in proc.stdout, \
        proc.stderr[-6000:]
    assert "data race" not in proc.stderr.lower(), proc.stderr[-6000:]
