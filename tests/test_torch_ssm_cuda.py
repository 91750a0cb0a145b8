"""The linear-scan kernels and the SSM and hybrid LMs on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_cuda.py

Without a CUDA device every test here skips.  ``linear_scan`` and
``linear_scan_bwd`` against their plain version on the same card inputs
at the smoke widths (falcon-mamba's C = 512 x 16, recurrentgemma's 256),
at ragged sizes (C not a multiple of 32, S not a multiple of a tile), and
at the full widths (falcon-mamba-7b's C = 8,192 x 16 and
recurrentgemma-2b's 2,560 at S 2,048), every output within 2e-6 of its
largest magnitude (the kernel sums each thread's steps in order, the
plain version by doubling; with a in (0, 1) a rounding error decays
along the sequence, and each stays within 2e-7 of an f64 sequential scan
on the CPU); the autograd Function against the CPU's; and 3 ``run_lm``
steps and 8 decode steps of both smoke configs on the card against the
CPU (losses within 1e-4 as the dense smoke parity, logits within 1e-5),
one forward and one backward launch a recurrent layer and step.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import linear_scan as LS
from repro_torch.launch.train import build_parser, run_lm
from repro_torch.models import api

pytestmark = pytest.mark.cuda
TOL = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(seed, B, S, C):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    a = 0.5 + 0.499 * torch.rand((B, S, C), generator=g, device="cuda")
    return a, draw(B, S, C), draw(B, C), draw(B, S, C), draw(B, C)


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert got.shape == want.shape and err <= TOL * max(scale, 1e-30), \
        f"{what}: max err {err} over max {scale}"


@pytest.mark.parametrize("B,S,C", [
    (2, 512, 512 * 16),        # falcon-mamba smoke
    (1, 2048, 256),            # recurrentgemma smoke
    (3, 1000, 1000),           # ragged: C % 32, S % 64 and S % 256 != 0
    (1, 7, 33), (2, 1, 5),
    (1, 2048, 8192 * 16),      # falcon-mamba-7b
    (1, 2048, 2560)])          # recurrentgemma-2b
def test_kernels_match_plain(cuda, B, S, C):
    a, b, h0, g, g_last = _inputs(B + S + C, B, S, C)
    n0 = dict(LS.LAUNCHES)
    h, h_last = LS.linear_scan(a, b, h0)
    da, db, dh0 = LS.linear_scan_backward(a, h, h0, g, g_last)
    torch.cuda.synchronize()
    assert {k: LS.LAUNCHES[k] - n0[k] for k in n0} == {
        "linear_scan": 1, "linear_scan_bwd": 1}
    want_h, want_last = LS.linear_scan_ref(a, b, h0)
    _close(h, want_h, "h")
    _close(h_last, want_last, "h_last")
    del want_h, want_last
    for name, got, want in zip(("da", "db", "dh0"), (da, db, dh0),
                               LS.linear_scan_bwd_ref(a, h, h0, g, g_last)):
        _close(got, want, name)


def test_function_on_card_matches_cpu(cuda):
    a, b, h0, w, w_last = _inputs(1, 2, 300, 70)
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).clone().requires_grad_() for t in (a, b, h0)]
        h, hl = LS.scan(*ts)
        ((h * w.to(dev)).sum() + (hl * w_last.to(dev)).sum()).backward()
        grads[dev] = [t.grad.cpu() for t in ts]
    for name, x, y in zip(("da", "db", "dh0"), grads["cuda"], grads["cpu"]):
        _close(x, y, name)


def test_wrapper_raises_on_the_card(cuda):
    a, b, h0, _, _ = _inputs(2, 2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        LS.linear_scan(a.transpose(1, 2), b.transpose(1, 2), h0)
    with pytest.raises(ValueError, match="several devices"):
        LS.linear_scan(a, b.cpu(), h0)
    h, h_last = LS.linear_scan(a[:, :0], b[:, :0], h0)
    assert h.shape == (2, 0, 64) and torch.equal(h_last, h0)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_smoke_steps_and_decode_on_card_match_cpu(cuda, arch):
    cfg = get_config(arch, smoke=True)
    cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    argv = ["--arch", arch, "--smoke", "--seq-len", "2048",
            "--batch-per-worker", "1", "--steps", "3"]
    losses = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        n0 = {**LS.LAUNCHES, **FA.LAUNCHES}
        out = run_lm(build_parser().parse_args(argv + ["--device", dev]),
                     model=model)
        ran = {k: v - n0[k] for k, v in {**LS.LAUNCHES,
                                          **FA.LAUNCHES}.items()}
        losses[dev] = [r["loss"] for r in out["metrics"]]
    n_rec = sum(k in ("mamba", "rglru") for k in cfg.kinds())
    assert ran == {"linear_scan": 3 * n_rec, "linear_scan_bwd": 3 * n_rec,
                   "flash_attention": 0, "flash_attention_bwd": 0}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-4)
    # decode, both from the CPU weights after the steps
    gpu = copy.deepcopy(cpu).to("cuda")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))
    caches = {d: api.init_decode_cache(cfg, 2, 8, d) for d in ("cpu",
                                                               "cuda")}
    for pos in range(8):
        x, caches["cpu"] = api.decode_step(cpu, cfg, toks[:, pos:pos + 1],
                                           caches["cpu"], pos)
        y, caches["cuda"] = api.decode_step(
            gpu, cfg, toks[:, pos:pos + 1].cuda(), caches["cuda"], pos)
        np.testing.assert_allclose(y.cpu().numpy(), x.numpy(), rtol=0,
                                   atol=1e-5, err_msg=str(pos))
