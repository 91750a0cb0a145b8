"""B8's f32 route on the CPU: the split TF32 products, emulated.

On the card f32 runs on the tensor cores as three TF32 products a product
(``csrc/sm90_tf32.cuh``): each operand x is split into hi = rna(x) and lo
= rna(x - hi), both exact TF32 values, and a b is taken as lo_a hi_b +
hi_a lo_b + hi_a hi_b with f32 sums, lo_a lo_b dropped.  The kernels run
only on a card; here the same arithmetic is written in PyTorch (the TF32
rounding by bit operations on the f32 pattern) and B8's forward, with the
kernel's online softmax over key tiles, and the backward's five products
are held, at small shapes (hd 32, 64, 128; causal and full; G 3), to the
card's tolerances against the f32 plain versions and against the JAX
package: 2e-5 on out and lse, 1e-4 on gradients.  One TF32 product alone
misses 2e-5, which is why the kernels take three.

The register A operand P comes from an accumulator that holds columns 2t
and 2t + 1 of its rows, where a k8 .tf32 fragment wants t and t + 4; the
transposed tiles store row j of each group of 8 at column kpos(j), and
the index test below replays that bookkeeping lane by lane.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels import flash_attn as tf

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
LOG2E = 1.4426950408889634
BN = 64                       # keys a tile of the forward kernel (hd <= 64)


def _rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 (ties away from zero), as f32 with
    the low 13 bits zero: ``cvt.rna.tf32.f32`` and the kernels' mask."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _rna(x)
    return hi, _rna(x.float() - hi)


def _mm3(spec: str, a, b, one: bool = False) -> torch.Tensor:
    """einsum(spec, a, b) as the kernels take it: three TF32 products of
    the split operands (the small terms first) summed in f32; ``one``
    keeps hi hi alone."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if one:
        return torch.einsum(spec, ah, bh)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
            + torch.einsum(spec, ah, bh))


def _mask(Sq, Sk, k0, n):
    """(Sq, n) bool: key k0 + t visible to the query at position s."""
    return torch.arange(k0, k0 + n)[None, :] <= torch.arange(Sq)[:, None]


def _fwd_tf32(q, k, v, causal, one=False, bn=BN):
    """The forward kernel's arithmetic: S = Q K^T split, the online
    softmax in f32 with 2^x of log2-scaled scores, P split, O += P V
    split; (out, lse)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    scale2 = np.float32(LOG2E / math.sqrt(hd))
    m = torch.full((B, KV, G, Sq), -math.inf)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    n_keys = min(Sk, Sq) if causal else Sk
    for k0 in range(0, n_keys, bn):
        kb, vb = k[:, k0:k0 + bn], v[:, k0:k0 + bn]
        s = _mm3("bskgh,btkh->bkgst", q, kb, one) * scale2
        if causal:
            s = s.masked_fill(~_mask(Sq, Sk, k0, kb.shape[1]), -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm3("bkgst,btkh->bkgsh", p, vb, one)
        m = m_new
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out, (m + torch.log2(l)) * math.log(2.0)


def _bwd_tf32(q, k, v, out, lse, dout, causal):
    """The backward kernels' arithmetic: the five products split, P from
    lse log2(e) with 2^x, D = rowsum(dO O) in f32; (dq, dk, dv)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    scale = np.float32(1 / math.sqrt(hd))
    scale2 = np.float32(LOG2E / math.sqrt(hd))
    D = (dout * out).sum(dim=-1).permute(0, 2, 3, 1)           # (B,KV,G,Sq)
    s = _mm3("bskgh,btkh->bkgst", q, k)
    p = torch.exp2(s * scale2 - (lse * np.float32(LOG2E))[..., None])
    if causal:
        p = p.masked_fill(~_mask(Sq, Sk, 0, Sk), 0.0)
    dv = _mm3("bkgst,bskgh->btkh", p, dout)
    dp = _mm3("bskgh,btkh->bkgst", dout, v)
    ds = p * (dp - D[..., None])
    dq = _mm3("bkgst,btkh->bskgh", ds, k) * scale
    dk = _mm3("bkgst,bskgh->btkh", ds, q) * scale
    return dq, dk, dv


def _draw(seed, B, Sq, Sk, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32))


def _jax_attention(q, k, v, causal):
    """The JAX package's route for these inputs: ``attention_flash``
    (causal, blocks of 64) or ``attention_naive`` bidirectional."""
    Sq, Sk = q.shape[1], k.shape[1]
    qp, kp = jnp.arange(Sq), jnp.arange(Sk)
    if causal:
        return jl.attention_flash(q, k, v, "full", 0, qp, kp, block=64)
    return jl.attention_naive(q, k, v, "full", 0, qp, kp,
                              bidirectional=True)


CASES = [(hd, causal) for hd in (32, 64, 128) for causal in (True, False)]


def test_split_is_exact_tf32():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32) * 10.0 ** np.random.default_rng(1)
        .integers(-6, 6, 100_000).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # hi is the nearest TF32, lo the nearest to the remainder: together
    # within 2^-22 of x, where hi alone is within 2^-11
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -22
    assert ((x.double() - hi.double()).abs() / x.double().abs()).max() \
        <= 2.0 ** -11
    assert torch.equal(_rna(hi), hi) and torch.equal(_rna(lo), lo)


def test_three_products_are_f32_accurate():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    want = a.double() @ b.double()
    three = (_mm3("ik,kj->ij", a, b).double() - want).abs().max()
    one = (_mm3("ik,kj->ij", a, b, one=True).double() - want).abs().max()
    plain = ((a @ b).double() - want).abs().max()
    assert three <= 4 * plain + 1e-6
    assert one > 100 * three


def test_fragment_order_matches_transposed_tiles():
    """A k8 .tf32 A fragment of thread (warp, lane): a0 = (g, t), a1 = (g
    + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4), g = 16 warp + lane /
    4, t = lane % 4; ``tf32_frag`` fills it with the accumulator's (g,
    2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1), and the transposed
    tile holds row ``kpos_row(p)`` of each 8 at column p.  Replayed for
    every lane, the product is P V."""
    rng = np.random.default_rng(4)
    n_keys, n = 16, 24
    P = rng.standard_normal((64, n_keys))
    V = rng.standard_normal((n_keys, n))
    kpos_row = [2 * p if p < 4 else 2 * p - 7 for p in range(8)]
    assert sorted(kpos_row) == list(range(8))
    # the transposed tile: column c of row d holds V[key(c), d]
    key_of = [8 * (c // 8) + kpos_row[c % 8] for c in range(n_keys)]
    Vt = np.array([[V[key_of[c], d] for c in range(n_keys)]
                   for d in range(n)])
    got = np.zeros((64, n))
    for warp in range(4):
        for lane in range(32):
            g, t = 16 * warp + lane // 4, lane % 4
            for ks in range(n_keys // 8):
                # the accumulator's n8 group ks: e0 (g, 2t), e1 (g, 2t +
                # 1), e2 (g + 8, 2t), e3 (g + 8, 2t + 1)
                e = [P[g, 8 * ks + 2 * t], P[g, 8 * ks + 2 * t + 1],
                     P[g + 8, 8 * ks + 2 * t], P[g + 8, 8 * ks + 2 * t + 1]]
                frag = [e[0], e[2], e[1], e[3]]        # tf32_frag's order
                where = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
                for val, (row, col) in zip(frag, where):
                    got[row] += val * Vt[:, 8 * ks + col]
    np.testing.assert_allclose(got, P @ V, rtol=0, atol=1e-12)


@pytest.mark.parametrize("hd,causal", CASES)
def test_forward_split_products(hd, causal):
    q, k, v, _ = _draw(hd + causal, 1, 192, 192, 2, 3, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _fwd_tf32(tq, tk, tv, causal, bn=32 if hd == 128 else BN)
    want, want_lse = tf.flash_attention_ref(tq, tk, tv, causal)
    torch.testing.assert_close(out, want, rtol=0, atol=FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FWD_TOL)
    ref = np.asarray(_jax_attention(*map(jnp.asarray, (q, k, v)), causal))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("Sq,Sk", [(130, 130), (100, 40), (40, 100)])
def test_forward_split_products_ragged(Sq, Sk):
    """Ragged tiles, Sq > Sk and Sq < Sk under the causal mask."""
    q, k, v, _ = _draw(Sq * Sk, 2, Sq, Sk, 2, 3, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _fwd_tf32(tq, tk, tv, True)
    want, want_lse = tf.flash_attention_ref(tq, tk, tv, True)
    torch.testing.assert_close(out, want, rtol=0, atol=FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FWD_TOL)


def test_one_tf32_product_misses_the_tolerance():
    q, k, v, _ = _draw(5, 1, 192, 192, 2, 3, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want, _ = tf.flash_attention_ref(tq, tk, tv, True)
    one, _ = _fwd_tf32(tq, tk, tv, True, one=True)
    three, _ = _fwd_tf32(tq, tk, tv, True)
    assert float((one - want).abs().max()) > FWD_TOL
    assert float((three - want).abs().max()) <= FWD_TOL


@pytest.mark.parametrize("hd,causal", CASES)
def test_backward_split_products(hd, causal):
    q, k, v, w = _draw(hd + 7 * causal, 1, 192, 192, 2, 3, hd)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    out, lse = tf.flash_attention_ref(tq, tk, tv, causal)
    got = _bwd_tf32(tq, tk, tv, out, lse, tw, causal)
    want = tf.flash_attention_bwd(tq, tk, tv, out, lse, tw, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL,
                                   msg=lambda m, n=name: f"{n}: {m}")

    def f(q_, k_, v_):
        return jnp.sum(_jax_attention(q_, k_, v_, causal) * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_backward_split_products_ragged():
    """Sq > Sk under the causal mask: rows past the last key see them all."""
    q, k, v, w = _draw(11, 1, 100, 40, 3, 3, 64)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    out, lse = tf.flash_attention_ref(tq, tk, tv, True)
    got = _bwd_tf32(tq, tk, tv, out, lse, tw, True)
    want = tf.flash_attention_bwd(tq, tk, tv, out, lse, tw, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL)
