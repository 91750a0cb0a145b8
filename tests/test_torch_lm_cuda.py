"""The LM's serving path and MoE layers on a CUDA card against the CPU.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_cuda.py

Without a CUDA device every test here skips.  From the same seeded f32
smoke weights: 8 decode steps on the card against the CPU (logits within
1e-5: f32 sums in another order), ``moe_ffn`` and its aux with dropped
pairs (1e-5), twice on the card bit for bit (each token's output is the
sum of at most K = 2 contributions added to zero, so the atomic adds
give one answer in any order), and a prefill at S = 2,048 through B8's
kernel (one launch a layer; 1e-4, the f32 CUDA-core kernel against the
CPU's plain version).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import api
from repro_torch.models import layers as tl

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _models(arch):
    cfg = get_config(arch, smoke=True)
    cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_decode_on_card_matches_cpu(cuda, arch):
    cfg, cpu, gpu = _models(arch)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))
    caches = {"cpu": api.init_decode_cache(cfg, 2, 8, "cpu"),
              "cuda": api.init_decode_cache(cfg, 2, 8, "cuda")}
    for pos in range(8):
        a, caches["cpu"] = api.decode_step(cpu, cfg, toks[:, pos:pos + 1],
                                           caches["cpu"], pos)
        b, caches["cuda"] = api.decode_step(
            gpu, cfg, toks[:, pos:pos + 1].cuda(), caches["cuda"], pos)
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=TOL, err_msg=str(pos))
    for c, d in zip(caches["cpu"], caches["cuda"]):
        assert torch.equal(c["pos"], d["pos"].cpu())


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_on_card_matches_cpu_and_itself(cuda, cf):
    cfg, cpu, gpu = _models("phi3.5-moe-42b-a6.6b")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, want_aux = tl.moe_ffn(cpu.layers[0].ffn, x, cfg, cf)
        got, aux = tl.moe_ffn(gpu.layers[0].ffn, x.cuda(), cfg, cf)
        again, _ = tl.moe_ffn(gpu.layers[0].ffn, x.cuda(), cfg, cf)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=TOL)
    assert abs(aux.item() - want_aux.item()) < TOL
    assert torch.equal(got, again)


def test_prefill_on_card_runs_b8(cuda):
    cfg, cpu, gpu = _models("smollm-360m")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 2048)))
    step = make_prefill_step(cfg)
    want = step(cpu, {"tokens": toks})
    n0 = FA.LAUNCHES["flash_attention"]
    got = step(gpu, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] - n0 == cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
