"""B8 on the CPU: the port's flash attention against the JAX package's.

The CUDA kernel runs only on a card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); here the wrapper takes its plain version, the f32
online softmax over key tiles.  It is held against

- the reference's Pallas ``flash_attention`` in interpret mode, at the
  shapes of ``tests/test_kernels_flash.py`` and at G = 3 (smollm's
  15 heads over 5 KV heads), and its lse against a log-sum-exp of the
  reference oracle's logits;
- the reference's jnp ``attention_flash`` (the model's route at S >=
  2048), forward at S = 2048 and, through the port's autograd Function,
  the gradients of a weighted sum against ``jax.grad``.

All in f32 from numpy draws of one seed.  Tolerances: 2e-5 absolute on
outputs of magnitude ~1 (sums of the same products in another order,
f32), 1e-4 on gradients (two more reductions over up to 2,048 keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro.models import layers as jl
from repro_torch.kernels import flash_attn as tf
from repro_torch.models import layers as tl

FWD_TOL, GRAD_TOL = 2e-5, 1e-4


def _qkv(seed, B, Sq, Sk, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,causal", [
    (1, 128, 128, 1, 1, 64, True),
    (2, 256, 256, 2, 3, 64, True),
    (1, 128, 256, 2, 1, 32, False),
    (2, 128, 128, 4, 2, 128, True),
    (1, 256, 256, 5, 3, 64, True),
    (1, 192, 192, 5, 3, 64, False),
])
def test_plain_matches_pallas_kernel(B, Sq, Sk, KV, G, hd, causal):
    q, k, v = _qkv(Sq + Sk + KV, B, Sq, Sk, KV, G, hd)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, bq=64, bk=64)
    n0 = tf.LAUNCHES["flash_attention"]
    out, lse = tf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal)
    assert tf.LAUNCHES["flash_attention"] == n0     # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    # lse: the log-sum-exp of the masked logits
    logits = np.einsum("bskgh,btkh->bkgst", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(hd)
    if causal:
        logits = np.where(np.tri(Sq, Sk, dtype=bool), logits, -np.inf)
    mx = logits.max(axis=-1)
    ref_lse = mx + np.log(np.exp(logits - mx[..., None]).sum(axis=-1))
    assert lse.shape == (B, KV, G, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("block", [64, 512])
def test_plain_is_block_invariant(block):
    q, k, v = _qkv(0, 1, 256, 256, 2, 3, 32)
    a = tf.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block=block)
    b = tf.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block=100)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=FWD_TOL)


def test_attention_flash_matches_reference_at_2048():
    """The model's route at S = 2048 (smoke widths: 4 heads over 2)."""
    q, k, v = _qkv(7, 1, 2048, 2048, 2, 2, 64)
    pos = jnp.arange(2048)
    want = jl.attention_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              "full", 0, pos, pos)
    got = tl.attention_flash(*map(torch.from_numpy, (q, k, v)), "full")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("S,block", [(2048, None), (384, 128)])
def test_gradients_match_jax_grad(S, block):
    q, k, v = _qkv(S, 1, S, S, 2, 3, 64)
    w = np.random.default_rng(S + 1).standard_normal(q.shape).astype(
        np.float32)
    pos = jnp.arange(S)

    def f(q_, k_, v_):
        out = jl.attention_flash(q_, k_, v_, "full", 0, pos, pos,
                                 block=block)
        return jnp.sum(out * w)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tf.flash_attn(tq, tk, tv, causal=True) * torch.from_numpy(w)).sum() \
        .backward()
    for name, a, b in zip("qkv", want, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_non_causal_gradients_match_autograd_of_softmax():
    """No reference route is non-causal; hold the backward against
    autograd of plain softmax attention instead (f64)."""
    q, k, v = _qkv(3, 2, 96, 160, 1, 2, 32)
    w = np.random.default_rng(4).standard_normal(q.shape)
    grads = []
    for plain in (False, True):
        tq, tk, tv = (torch.from_numpy(a).double().requires_grad_()
                      for a in (q, k, v))
        if plain:
            s = torch.einsum("bskgh,btkh->bkgst", tq, tk) / np.sqrt(32)
            out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), tv)
        else:
            out = tf.flash_attn(tq, tk, tv, causal=False)
        (out * torch.from_numpy(w)).sum().backward()
        grads.append([t.grad.float() for t in (tq, tk, tv)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q[0], k, v), "5 dimensions"),
    (lambda q, k, v: (q, k[:, :, :1], v[:, :, :1]), "must be"),
    (lambda q, k, v: (q, k, v[:, :10]), "must be"),
    (lambda q, k, v: (q, k[:, :0], v[:, :0]), "at least one key"),
    (lambda q, k, v: (q.long(), k, v), "float"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 16, 16, 2, 2, 32))
    with pytest.raises((ValueError, TypeError), match=match):
        tf.flash_attention(*bad(q, k, v))


def test_local_attention_at_flash_length_raises():
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 8, 8, 1, 1, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        tl.attention_flash(q, k, v, "local")
