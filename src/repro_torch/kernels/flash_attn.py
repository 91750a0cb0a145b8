"""Blockwise GQA flash attention (B8): wrapper, plain version, and the
autograd Function the LM trains through.

:func:`flash_attention` — for q (B, Sq, KV, G, hd) and k, v (B, Sk, KV,
hd), every query row's softmax attention over the keys at positions
``t <= s`` (``causal``) or over all keys, by the online softmax with an
f32 running max, sum and accumulator.  Returns ``out`` (B, Sq, KV, G, hd)
in q's dtype and the row log-sum-exp ``lse`` (B, KV, G, Sq) in f32, which
the backward reads.  Positions are 0 .. S-1 on both sides, as the LM's
``attention_train`` passes them; the mask is causal or none (the local
and chunked masks of ``models/layers.py::_pair_mask`` take the naive
path).  Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py:
flash_attention``.  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/flash_attn.cu``, which states what bounds it and how its design
answers it.

The wrapper checks device, dtype and shapes and raises on anything its
kernel does not take: bf16 or f32, hd of 32, 64 or 128, inputs read
through their strides.  Given CUDA tensors it launches the kernel on the
current stream or raises; it runs the plain version
(:func:`flash_attention_ref`) only because the tensors lie on the CPU.
``LAUNCHES`` counts kernel launches.

:func:`flash_attn` is the differentiable form: its forward is
:func:`flash_attention`, its backward :func:`flash_attention_bwd`, plain
PyTorch blockwise over key tiles from the saved q, k, v, out and lse (the
TPU kernel had no backward either: JAX differentiates the jnp scan).
"""
from __future__ import annotations

import torch

from .emb_lookup import _on_cuda, _raise_on

__all__ = ["LAUNCHES", "BLOCK", "flash_attention", "flash_attention_ref",
           "flash_attention_bwd", "flash_attn"]

LAUNCHES = {"flash_attention": 0}
NEG = -1e30
BLOCK = 512          # key tile of the plain version and of the backward
_HEAD_DIMS = (32, 64, 128)


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for name, t, nd in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dimensions, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    B, Sq, KV, G, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (KV, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Sk, KV, hd) = ({B}, Sk, {KV}, {hd}) for q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    return B, Sq, KV, G, hd, k.shape[1]


def _mask(q0: int, nq: int, k0: int, nk: int, device) -> torch.Tensor:
    """(nq, nk) bool, True where key position k0 + t <= query q0 + s."""
    qp = torch.arange(q0, q0 + nq, device=device)
    kp = torch.arange(k0, k0 + nk, device=device)
    return kp[None, :] <= qp[:, None]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block: int = BLOCK):
    """Plain PyTorch version of :func:`flash_attention`: the online
    softmax over key tiles of ``block``, all in f32; under ``causal`` the
    keys past the last query position are skipped.  Returns (out in q's
    dtype, lse f32)."""
    B, Sq, KV, G, hd, Sk = _shapes(q, k, v)
    scale = hd ** -0.5
    qf = q.float()
    m = torch.full((B, KV, G, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    n_keys = min(Sk, Sq) if causal else Sk
    for k0 in range(0, n_keys, block):
        kb = k[:, k0:k0 + block].float()
        vb = v[:, k0:k0 + block].float()
        s = torch.einsum("bskgh,btkh->bkgst", qf, kb) * scale
        if causal:
            s = s.masked_fill(~_mask(0, Sq, k0, kb.shape[1], q.device), NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkh->bkgsh", p, vb)
        m = m_new
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).to(q.dtype)
    return out, m + torch.log(l)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """B8's forward: (out (B, Sq, KV, G, hd) in q's dtype, lse (B, KV, G,
    Sq) f32).  q, k and v share one dtype on the card (bf16 or f32)."""
    B, Sq, KV, G, hd, Sk = _shapes(q, k, v)
    if not _on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {_HEAD_DIMS}, got "
                         f"{hd}")
    out = torch.empty((B, Sq, KV, G, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * KV * G == 0:
        return out, lse
    from ._build import load_library

    lib = load_library("flash_attn")
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, KV, G, hd,
        int(q.dtype == torch.bfloat16), int(causal), *q.stride(),
        *k.stride(), *v.stride(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        block: int = BLOCK):
    """Gradients of :func:`flash_attention`'s ``out`` for ``dout``, in
    f32, one key tile of ``block`` at a time (O(S x block) memory):
    ``D = rowsum(dO * O)``, ``P = exp(S * scale - lse)``, ``dV += P^T
    dO``, ``dS = P * (dO V^T - D)``, ``dQ += dS K * scale``, ``dK +=
    dS^T Q * scale``.  Under ``causal`` a tile meets only the query rows
    at or past its first key.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, KV, G, hd, Sk = _shapes(q, k, v)
    scale = hd ** -0.5
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    D = (do * out.float()).sum(dim=-1).permute(0, 2, 3, 1)   # (B,KV,G,Sq)
    dq, dk, dv = (torch.zeros_like(qf), torch.zeros_like(kf),
                  torch.zeros_like(vf))
    n_keys = min(Sk, Sq) if causal else Sk
    for k0 in range(0, n_keys, block):
        k1 = min(k0 + block, n_keys)
        q0 = k0 if causal else 0
        qb, dob = qf[:, q0:], do[:, q0:]
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        s = torch.einsum("bskgh,btkh->bkgst", qb, kb) * scale
        p = torch.exp(s - lse[..., q0:, None])
        if causal:
            p = p.masked_fill(~_mask(q0, Sq - q0, k0, k1 - k0, q.device), 0.0)
        dv[:, k0:k1] += torch.einsum("bkgst,bskgh->btkh", p, dob)
        dp = torch.einsum("bskgh,btkh->bkgst", dob, vb)
        ds = p * (dp - D[..., q0:, None])
        dq[:, q0:] += torch.einsum("bkgst,btkh->bskgh", ds, kb) * scale
        dk[:, k0:k1] += torch.einsum("bkgst,bskgh->btkh", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True) -> torch.Tensor:
    """Differentiable B8: ``flash_attention(q, k, v, causal)[0]`` with the
    blockwise backward."""
    return _FlashAttention.apply(q, k, v, causal)
