"""B8's route rule on the CPU: which card kernel takes which inputs.

The bf16 forward runs on the tensor cores (``wgmma`` fed by TMA), which
read k and v by TMA boxes and q by 16-byte loads; f32 runs on the CUDA
cores through any strides.  The rule is a pure function of dtypes, hd and
each tensor's (shape, strides, address), so it is tested here without a
card, on CPU tensors' layouts.  The smoke LM's q, k and v, as they reach
B8, must meet the bf16 route's rule.  The autograd Function's backward
goes through :func:`flash_attention_backward`, which on the CPU is the
plain :func:`flash_attention_bwd`, exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as tf
from repro_torch.models import api, layers


def _layout(t):
    return tuple(t.shape), tuple(t.stride()), t.data_ptr()


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
])
def test_route_by_dtype(dtype, hd, route):
    assert tf.kernel_route((dtype,) * 3, hd) == route


@pytest.mark.parametrize("dtypes,hd,err,match", [
    ((torch.float16,) * 3, 64, TypeError, "bf16 or f32"),
    ((torch.bfloat16, torch.float32, torch.float32), 64, TypeError,
     "one dtype"),
    ((torch.float64,) * 3, 64, TypeError, "bf16 or f32"),
    ((torch.bfloat16,) * 3, 48, ValueError, "hd in"),
    ((torch.float32,) * 3, 256, ValueError, "hd in"),
])
def test_route_raises_on_what_no_kernel_takes(dtypes, hd, err, match):
    with pytest.raises(err, match=match):
        tf.kernel_route(dtypes, hd)


def _views():
    base = torch.zeros((2, 64, 3, 4 * 72), dtype=torch.bfloat16)
    fused = torch.zeros((2, 64, 3, 5, 64), dtype=torch.bfloat16)
    return {
        "contiguous": (torch.zeros((2, 64, 3, 64), dtype=torch.bfloat16),
                       None),
        "fused projection (unit inner stride)": (fused[:, :, :, 3], None),
        "padded rows of 72": (base[..., :64], None),
        "length-1 dims with odd strides": (
            torch.zeros((1, 64, 1, 67), dtype=torch.bfloat16)[..., :64]
            .as_strided((1, 64, 1, 64), (5, 64, 3, 1)), None),
        "transposed (inner stride 64)": (
            torch.zeros((2, 3, 64, 64), dtype=torch.bfloat16)
            .transpose(-1, -2), "innermost stride"),
        "rows of 68 (136 bytes)": (
            torch.zeros((2, 64, 3, 68), dtype=torch.bfloat16)[..., :64],
            "multiple of 16 bytes"),
        "misaligned by 2 bytes": (
            torch.zeros(2 * 64 * 3 * 64 + 1, dtype=torch.bfloat16)[1:]
            .view(2, 64, 3, 64), "16-byte aligned"),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_tma_layout_rule(name):
    t, fault = _views()[name]
    got = tf.tma_layout_fault(t.shape, t.stride(), t.data_ptr())
    if fault is None:
        assert got is None
    else:
        assert fault in got


def test_bf16_route_raises_on_a_view_tma_cannot_take():
    q = torch.zeros((1, 64, 3, 1, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 3, 64, 64), dtype=torch.bfloat16).transpose(1, 2)
    k = k.transpose(-1, -2)                  # innermost stride 64
    good = torch.zeros((1, 64, 3, 64), dtype=torch.bfloat16)
    assert tf.kernel_route((torch.bfloat16,) * 3, 64,
                           [_layout(q), _layout(good), _layout(good)]) \
        == "wgmma"
    with pytest.raises(ValueError, match="bf16 route cannot read k"):
        tf.kernel_route((torch.bfloat16,) * 3, 64,
                        [_layout(q), _layout(k), _layout(good)])
    # f32 takes any strides
    assert tf.kernel_route((torch.float32,) * 3, 64,
                           [_layout(q), _layout(k), _layout(good)]) \
        == "cuda_cores"


def test_tma_strides_fill_length_one_dims():
    t = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    assert tf._tma_strides(t) == (8, 64, 8, 1)


@pytest.mark.parametrize("arch", ["smollm-360m"])
def test_smoke_lm_qkv_meet_the_bf16_rule(arch, monkeypatch):
    """The model's q and k come out of ``rope`` and v out of an einsum:
    at S = 2,048 in bf16, all three reach B8 in a layout the bf16 route
    reads without a copy."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    seen = []
    plain = layers.flash_attn

    def spy(q, k, v, causal=True):
        seen.append((q, k, v))
        return plain(q, k, v, causal)

    monkeypatch.setattr(layers, "flash_attn", spy)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 2049)))
    with torch.no_grad():
        api.train_loss(model, cfg, {"tokens": tok[:, :-1],
                                    "labels": tok[:, 1:]})
    assert len(seen) == cfg.n_layers
    for q, k, v in seen:
        assert q.dtype == torch.bfloat16
        assert tf.kernel_route((q.dtype, k.dtype, v.dtype), q.shape[-1],
                               [_layout(t) for t in (q, k, v)]) == "wgmma"


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_backward_is_flash_attention_backward(causal, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 96, 2, 3, 32), (1, 96, 2, 32), (1, 96, 2, 32)))
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    calls = []
    routed = tf.flash_attention_backward

    def spy(*a):
        calls.append(1)
        return routed(*a)

    monkeypatch.setattr(tf, "flash_attention_backward", spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad((tf.flash_attn(*leaves, causal) * w).sum(),
                              leaves)
    assert calls == [1]
    out, lse = tf.flash_attention(q, k, v, causal)
    want = tf.flash_attention_bwd(q, k, v, out, lse, w, causal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n0 = dict(tf.LAUNCHES)
    again = tf.flash_attention_backward(q, k, v, out, lse, w, causal)
    assert tf.LAUNCHES == n0            # the CPU runs the plain version
    for a, b in zip(again, want):
        assert torch.equal(a, b)
