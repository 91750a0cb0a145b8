"""Multi-PS training and the dense cache engine on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ps_cuda.py

Without a CUDA device every test here skips.  B1 over the per-shard
table (2 and 3 shards, random and ``--ps-hetero`` links) and over the
dense (V, 4) table is bit for bit its plain version on the CPU, and the
dense table gives the compact route's bits.  ``run_dlrm`` at wdl-tiny
(4 workers of 8, 5 steps, ragged exchange, alpha 1) with ``--n-ps 3
--ps-layout hashed --ps-hetero``, with 2 PS under a PS outage, and with
``--esd-engine dense`` at depth 1 and 2: the card's records equal the
CPU's in every integer field, losses, costs and Alg.-1 estimates within
1e-5 (the card's products sum in another order); depth 2's equal depth
1's bit for bit, and the dense engine's equal the sparse engine's.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.simulator import hetero_ps_bandwidths
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.kernels import emb_lookup as K
from repro_torch.kernels import ops as O
from repro_torch.launch.train import build_parser, run_dlrm
from repro_torch.models.dlrm import init_params
from repro_torch.ps import make_partition

pytestmark = pytest.mark.cuda

ARCH = "wdl-tiny"
BASE = ["--arch", ARCH, "--workers", "4", "--batch-per-worker", "8",
        "--steps", "5", "--esd-alpha", "1", "--exchange", "ragged",
        "--seed", "0"]
INTS = ("miss_pull", "update_push", "evict_push")
KEYS = ("loss", "cost", "alg1_est") + INTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py also runs the "
                    "multi-PS and dense-engine paths on the card)")
    return torch.device("cuda")


def _state(rng, n, V):
    latest = rng.random((n, V)) < 0.4
    return latest, latest & (rng.random((n, V)) < 0.5)


@pytest.mark.parametrize("n_ps,layout,hetero", [(2, "contiguous", True),
                                                (3, "hashed", False)])
def test_per_shard_route_bitwise(cuda, n_ps, layout, hetero):
    wl = WORKLOADS["S1"]
    rng = np.random.default_rng(n_ps)
    part = make_partition(wl.vocab, n_ps, layout)
    latest, dirty = _state(rng, 4, part.linear_size)
    lin = np.asarray(part.to_linear(wl.sample_batch(rng, 256))).astype(
        np.int32)
    t = ((512 * 4.0) / hetero_ps_bandwidths(4, n_ps) if hetero
         else rng.random((4, n_ps)) * 1e-5 + 1e-6).astype(np.float32)
    cpu = [torch.as_tensor(a) for a in (lin, latest, dirty, t)]
    gpu = [a.to(cuda) for a in cpu]
    table, inv, w = O.cost_table_sparse_ps(*gpu, part)
    launched = K.LAUNCHES["pooled_lookup"]
    got = K.pooled_lookup(table, inv, w)
    assert K.LAUNCHES["pooled_lookup"] == launched + 1
    assert torch.equal(got, K.pooled_lookup_ref(table, inv, w))
    assert torch.equal(got.cpu(), O.cost_matrix_sparse_ps_kernel(*cpu, part))


def test_dense_table_route_bitwise(cuda):
    wl = WORKLOADS["S1"]
    rng = np.random.default_rng(5)
    latest, dirty = _state(rng, 4, wl.vocab)
    s = wl.sample_batch(rng, 256).astype(np.int32)
    t = (rng.random(4) * 1e-5 + 1e-6).astype(np.float32)
    gpu = [torch.as_tensor(a).to(cuda) for a in (s, latest, dirty, t)]
    table, ids, w = O.cost_table_dense(*gpu)
    assert table.shape == (wl.vocab, 4)
    got = K.pooled_lookup(table, ids, w)
    assert torch.equal(got, K.pooled_lookup_ref(table, ids, w))
    assert torch.equal(got, O.cost_matrix_sparse_kernel(*gpu))


def _model():
    cfg = DLRM_CONFIGS[ARCH]
    return init_params(cfg, WORKLOADS[cfg.workload],
                       torch.Generator().manual_seed(0), "cpu")


def _runs(extra, cuda):
    cpu = _model()
    return {dev: run_dlrm(build_parser().parse_args(
                BASE + extra + ["--device", dev]),
                model=copy.deepcopy(cpu).to(dev))["metrics"]
            for dev in ("cpu", "cuda")}


def _close(card, cpu):
    for a, b in zip(cpu, card, strict=True):
        for key in INTS:
            assert a[key] == b[key], key
        for key in ("loss", "cost", "alg1_est"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5)


@pytest.mark.parametrize("extra", [
    ["--n-ps", "3", "--ps-layout", "hashed", "--ps-hetero"],
    ["--n-ps", "2", "--fault-plan", "ps_outage@1:1-4; straggle@2:0x2-3"],
    ["--esd-engine", "dense"]])
def test_driver_card_against_cpu(cuda, extra):
    runs = _runs(extra, cuda)
    _close(runs["cuda"], runs["cpu"])
    deep = run_dlrm(build_parser().parse_args(
        BASE + extra + ["--device", "cuda", "--pipeline-depth", "2"]),
        model=_model().to(cuda))["metrics"]
    assert ([[r[k] for k in KEYS] for r in deep]
            == [[r[k] for k in KEYS] for r in runs["cuda"]])
    if "dense" in extra:
        sparse = run_dlrm(build_parser().parse_args(
            BASE + ["--device", "cuda"]),
            model=_model().to(cuda))["metrics"]
        assert ([[r[k] for k in KEYS] for r in sparse]
                == [[r[k] for k in KEYS] for r in runs["cuda"]])
