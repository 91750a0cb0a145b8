"""Blockwise GQA flash attention (B8): wrappers, plain versions, and the
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
flash_attention``.  The card has two kernels for it, chosen by dtype
(:func:`kernel_route`), openly and never as a fallback: bf16 runs on the
tensor cores (``csrc/flash_attn_sm90.cu``: ``wgmma`` fed by TMA, P
rounded to bf16 for the P V product), f32 on the CUDA cores
(``csrc/flash_attn.cu``, read through any strides).  Each source states
what bounds it and how its design answers it.

:func:`flash_attention_backward` — the gradients (dq, dk, dv) of
``out`` for ``dout``, from the saved q, k, v, out and lse.  On the card
it is ``csrc/flash_attn_bwd.cu`` (bf16 products on the tensor cores by
``mma.sync``, f32 on the CUDA cores); its plain version
:func:`flash_attention_bwd` recomputes P in f32 one key tile at a time.
The TPU kernel had no backward: JAX differentiates the jnp scan.

The wrappers check device, dtype, shapes and strides and raise on
anything their kernels do not take.  Given CUDA tensors they launch a
kernel on the current stream or raise; they run the plain versions only
because the tensors lie on the CPU.  ``LAUNCHES`` counts kernel launches
(both forward routes under ``flash_attention``), ``ROUTE_LAUNCHES`` the
forward's per route.

:func:`flash_attn` is the differentiable form: an autograd Function whose
forward is :func:`flash_attention` and whose backward is
:func:`flash_attention_backward`.
"""
from __future__ import annotations

import torch

from .emb_lookup import _on_cuda, _raise_on

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "BLOCK", "kernel_route",
           "tma_layout_fault", "flash_attention", "flash_attention_ref",
           "flash_attention_backward", "flash_attention_bwd", "flash_attn"]

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}
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


def tma_layout_fault(shape, strides, data_ptr: int,
                     itemsize: int = 2) -> str | None:
    """Why a tensor of this shape, element strides and address cannot be
    read 16 bytes a row chunk (TMA boxes for k and v, vector loads for
    q), or ``None`` when it can: the innermost stride must be 1, every
    other dimension longer than 1 must step a positive multiple of 16
    bytes, and the data must start 16-byte aligned."""
    shape, strides = tuple(shape), tuple(strides)
    if shape[-1] > 1 and strides[-1] != 1:
        return f"innermost stride {strides[-1]}, not 1"
    for n, st in zip(shape[:-1], strides[:-1]):
        if n > 1 and (st <= 0 or st * itemsize % 16):
            return (f"stride {st} of a dimension of {n} is not a positive "
                    f"multiple of 16 bytes")
    if data_ptr % 16:
        return f"data at {data_ptr:#x} is not 16-byte aligned"
    return None


def kernel_route(dtypes, hd: int, layouts=()) -> str:
    """The card kernel for q, k, v of these dtypes and head width:
    ``"wgmma"`` (bf16, tensor cores) or ``"cuda_cores"`` (f32).  Raises on
    mixed or other dtypes, on an hd the kernels do not take, and, on the
    bf16 route, on a (shape, strides, data_ptr) in ``layouts`` that
    :func:`tma_layout_fault` refuses: the route never copies a view."""
    dtypes = tuple(dtypes)
    if len(set(dtypes)) != 1 or dtypes[0] not in (torch.bfloat16,
                                                  torch.float32):
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one "
                        f"dtype, got {', '.join(map(str, dtypes))}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {_HEAD_DIMS}, got "
                         f"{hd}")
    if dtypes[0] == torch.float32:
        return "cuda_cores"
    for name, (shape, strides, ptr) in zip("qkv", layouts):
        fault = tma_layout_fault(shape, strides, ptr)
        if fault is not None:
            raise ValueError(f"flash_attention's bf16 route cannot read "
                             f"{name} {tuple(shape)} with strides "
                             f"{tuple(strides)}: {fault}; pass a "
                             f"contiguous tensor")
    return "wgmma"


def _layout(t: torch.Tensor):
    return tuple(t.shape), tuple(t.stride()), t.data_ptr()


def _tma_strides(t: torch.Tensor) -> tuple:
    """t's element strides with those of length-1 dimensions set to 8
    (16 bytes), which TMA takes and never steps."""
    return tuple(st if n > 1 else 8 for n, st in zip(t.shape, t.stride()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """B8's forward: (out (B, Sq, KV, G, hd) in q's dtype, lse (B, KV, G,
    Sq) f32).  q, k and v share one dtype on the card: bf16 (strides as
    :func:`tma_layout_fault` allows) or f32 (any strides)."""
    B, Sq, KV, G, hd, Sk = _shapes(q, k, v)
    if not _on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal)
    route = kernel_route((q.dtype, k.dtype, v.dtype), hd,
                         [_layout(t) for t in (q, k, v)])
    out = torch.empty((B, Sq, KV, G, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * KV * G == 0:
        return out, lse
    from ._build import load_library

    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        rc = load_library("flash_attn_sm90").flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, KV, G, hd, int(causal),
            *_tma_strides(q)[:4], *_tma_strides(k)[:3],
            *_tma_strides(v)[:3], stream)
    else:
        rc = load_library("flash_attn").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, KV, G, hd, int(causal),
            *q.stride(), *k.stride(), *v.stride(), stream)
    _raise_on(rc, f"flash_attention ({route})")
    LAUNCHES["flash_attention"] += 1
    ROUTE_LAUNCHES[route] += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention`'s ``out`` for ``dout``, in
    the inputs' dtypes.  On the card the kernel of
    ``csrc/flash_attn_bwd.cu`` (q, k, v and dout of one dtype, bf16 or
    f32, read through their strides where :func:`tma_layout_fault` takes
    them, else copied first; out and lse as the forward returns them); on
    the CPU the plain :func:`flash_attention_bwd`."""
    B, Sq, KV, G, hd, Sk = _shapes(q, k, v)
    if not _on_cuda(q, k, v, out, lse, dout):
        return flash_attention_bwd(q, k, v, out, lse, dout, causal)
    dtypes = (q.dtype, k.dtype, v.dtype, dout.dtype, out.dtype)
    kernel_route(dtypes, hd)
    if (out.shape != q.shape or dout.shape != q.shape
            or not out.is_contiguous()):
        raise ValueError(f"out (contiguous) and dout must have q's shape "
                         f"{tuple(q.shape)}, got {tuple(out.shape)} and "
                         f"{tuple(dout.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, KV, G, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous f32 ({B}, {KV}, {G}, "
                         f"{Sq}), got {lse.dtype} {tuple(lse.shape)}")
    if Sq * G >= 2**31:
        raise ValueError(f"flash_attention_bwd indexes Sq x G = {Sq * G} "
                         f"rows in 32 bits")
    dq = torch.empty((B, Sq, KV, G, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B * Sq * KV * G == 0:
        return dq, dk.zero_(), dv.zero_()
    from ._build import load_library

    # the kernel loads rows 16 bytes at a time: a view it cannot read so
    # (dout as autograd hands it over, hd not innermost) is copied once
    q, k, v, dout = (
        t if tma_layout_fault(t.shape, t.stride(), t.data_ptr(),
                              t.element_size()) is None
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, dout))
    delta = torch.empty_like(lse)
    rc = load_library("flash_attn_bwd").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, KV, G, hd,
        int(q.dtype == torch.bfloat16), int(causal), *q.stride()[:4],
        *k.stride()[:3], *v.stride()[:3], *dout.stride()[:4],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        block: int = BLOCK):
    """Plain PyTorch version of :func:`flash_attention_backward`:
    gradients of :func:`flash_attention`'s ``out`` for ``dout``, in f32,
    one key tile of ``block`` at a time (O(S x block) memory):
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
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal)
        return dq, dk, dv, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True) -> torch.Tensor:
    """Differentiable B8: ``flash_attention(q, k, v, causal)[0]`` with
    :func:`flash_attention_backward` as its gradient."""
    return _FlashAttention.apply(q, k, v, causal)
