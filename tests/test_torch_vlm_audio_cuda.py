"""The VLM prefix and the audio encoder-decoder on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_vlm_audio_cuda.py

Without a CUDA device every test here skips.  pixtral-12b's and
whisper-large-v3's smoke configs (f32) on the card against the CPU from
the same weights and ``make_train_batch`` draws: the loss and step 0's
gradients (1e-5, and 1e-4 of each leaf's largest), 3 ``make_train_step``
steps (losses within 1e-3: Adam at lr 1e-2 parts the runs' weights;
pixtral at 16 patches + 2,032 tokens runs B8 and its backward once a
layer and step, whisper no kernel), the prefill with a prefix (B8's f32
kernel in every layer; logits within 1e-4), 8 decode steps (logits
within 1e-5), and
whisper's decode over cross K/V filled from the encoder's memory against
``decode_train``'s logits on the card (1e-4: GEMVs against GEMMs).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import api, whisper
from repro_torch.optim import get_optimizer

pytestmark = pytest.mark.cuda
SMOKE = {"pixtral-12b": (1, 2048), "whisper-large-v3": (2, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


def _batch(cfg, seed, B, S, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in
            api.make_train_batch(np.random.default_rng(seed), cfg, B,
                                 S).items()}


@pytest.mark.parametrize("arch", list(SMOKE))
def test_loss_and_gradients_card_vs_cpu(cuda, arch):
    """Step 0: the loss within 1e-5 and every gradient within 1e-4 of its
    leaf's largest (f32 sums in other orders; B8's f32 kernels against
    their plain versions, phase 3's 1e-4 for its backward)."""
    cfg, cpu, gpu = _pair(arch)
    B, S = SMOKE[arch]
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        loss = api.train_loss(model, cfg, _batch(cfg, 1, B, S, dev))
        out[dev] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= 1e-5
    names = [n for n, _ in cpu.named_parameters()]
    for name, a, b in zip(names, out["cpu"][1], out["cuda"][1]):
        scale = max(1.0, float(a.abs().max()))
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("arch", list(SMOKE))
def test_train_steps_card_vs_cpu(cuda, arch):
    """3 ``make_train_step`` steps on one batch: the losses within 1e-3.
    Adam at lr 1e-2 turns a rounding difference of a gradient near 0
    into a step of up to 2 lr on that weight, so the two runs' weights
    part after step 0 (the step-0 gradients above hold 1e-4)."""
    cfg, cpu, gpu = _pair(arch)
    B, S = SMOKE[arch]
    losses = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        step = make_train_step(cfg, model, get_optimizer("adam", 1e-2),
                               remat=False)
        batch = _batch(cfg, 1, B, S, dev)
        n0 = dict(FA.LAUNCHES)
        losses[dev] = [float(step(batch)) for _ in range(3)]
        ran = {k: FA.LAUNCHES[k] - n0[k] for k in n0}
    n = 3 * cfg.n_layers if cfg.family == "vlm" else 0
    assert ran == {"flash_attention": n, "flash_attention_bwd": n}
    assert np.all(np.isfinite(losses["cuda"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("arch", list(SMOKE))
def test_prefill_card_vs_cpu(cuda, arch):
    cfg, cpu, gpu = _pair(arch, seed=2)
    B, S = SMOKE[arch]
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        n0 = FA.LAUNCHES["flash_attention"]
        out[dev] = make_prefill_step(cfg)(model,
                                          _batch(cfg, 3, B, S, dev)).cpu()
        ran = FA.LAUNCHES["flash_attention"] - n0
    assert ran == (cfg.n_layers if cfg.family == "vlm" else 0)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", list(SMOKE))
def test_decode_card_vs_cpu(cuda, arch):
    cfg, cpu, gpu = _pair(arch, seed=4)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 8)))
    step = make_serve_step(cfg)
    caches = [api.init_decode_cache(cfg, 4, 8, d) for d in ("cpu", "cuda")]
    for pos in range(8):
        a, caches[0] = step(cpu, caches[0], toks[:, pos:pos + 1], pos)
        b, caches[1] = step(gpu, caches[1], toks[:, pos:pos + 1].cuda(), pos)
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=1e-5, err_msg=str(pos))


def test_whisper_decode_over_filled_cross_kv_on_the_card(cuda):
    cfg, _, gpu = _pair("whisper-large-v3", seed=6)
    b = _batch(cfg, 7, 2, 48, "cuda")
    with torch.no_grad():
        memory = whisper.encode(gpu, cfg, b["frames"])
        want = whisper.decode_train(gpu, cfg, b["tokens"], memory)
    cache = whisper.fill_cross_kv(
        gpu, cfg, api.init_decode_cache(cfg, 2, 48, "cuda"), memory)
    for t in range(48):
        got, cache = api.decode_step(gpu, cfg, b["tokens"][:, t:t + 1],
                                     cache, t)
        np.testing.assert_allclose(got[:, 0].cpu().numpy(),
                                   want[:, t].cpu().numpy(), rtol=0,
                                   atol=1e-4, err_msg=str(t))
