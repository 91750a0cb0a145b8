"""Core layers: the bias-free linear layer, RMSNorm, RoPE, GQA attention
for training (naive, and flash through kernel B8) and the dense MLPs.

The counterpart of the JAX package's ``models/layers.py`` for the DLRM
and the dense LM: functions ``(params, x, ...) -> y`` over tensors, with
the JAX package's layouts (a linear weight is ``(din, dout)`` and the
forward ``x @ w``; attention weights keep the GQA head structure:
``wq (D, KV, G, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (KV, G, hd, D)``).
Decode-time attention, cross-attention and MoE come with the rest of the
LM side (ROADMAP A14).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attn import flash_attn

__all__ = ["linear", "init_linear", "rmsnorm", "rope", "Attention",
           "init_attention", "attention_naive", "attention_flash",
           "attention_train", "MLP", "init_mlp", "mlp", "FLASH_MIN_SEQ",
           "FLASH_BLOCK"]

NEG_INF = -1e30
FLASH_BLOCK = 512          # kv block of the reference's scan-based flash
FLASH_MIN_SEQ = 2048       # below this, use naive attention (smoke tests)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def init_linear(din: int, dout: int, *, generator: torch.Generator,
                device, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else din ** -0.5
    return torch.randn((din, dout), generator=generator, device=device,
                       dtype=torch.float32) * scale


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with a zero-centred gain ``(1 + w)``, computed in f32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotary embedding in f32.  x: (B, S, *head_dims, hd);
    positions: (S,)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs               # (S, hd/2)
    # singleton head axes so that S lines up with x's sequence dim
    ang = ang.reshape(ang.shape[:-1] + (1,) * (x.dim() - 1 - ang.dim())
                      + ang.shape[-1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention masks (analytic per (q_pos, kv_pos); materialized only on the
# naive path)
# --------------------------------------------------------------------------
def _pair_mask(kind: str, window: int, q_pos, kv_pos):
    """Bool mask, True = attend.  q_pos (..., Sq), kv_pos (..., Sk)."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    causal = k <= q
    if kind == "full":
        return causal
    if kind == "local":
        return causal & (q - k < window)
    if kind == "chunked":
        return causal & (q // window == k // window)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA projections: ``wq (D, KV, G, hd)``, ``wk``/``wv (D, KV, hd)``,
    ``wo (KV, G, hd, D)``."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk = nn.Parameter(wq), nn.Parameter(wk)
        self.wv, self.wo = nn.Parameter(wv), nn.Parameter(wo)


def init_attention(cfg: ModelConfig, dtype, *, generator: torch.Generator,
                   device) -> Attention:
    """The JAX package's distributions: wq, wk, wv N(0, 1) * d**-0.5,
    wo N(0, 1) * (H hd)**-0.5, drawn in f32 and cast to ``dtype``."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV

    def nrm(shape, sc):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * sc).to(dtype)

    return Attention(nrm((d, KV, G, hd), d ** -0.5),
                     nrm((d, KV, hd), d ** -0.5), nrm((d, KV, hd), d ** -0.5),
                     nrm((KV, G, hd, d), (H * hd) ** -0.5))


def _qkv(p: Attention, x: torch.Tensor):
    """x: (B,S,D) -> q (B,S,KV,G,hd), k/v (B,S,KV,hd)."""
    q = torch.einsum("bsd,dkgh->bskgh", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dkh->bskh", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dkh->bskh", x, p.wv.to(x.dtype))
    return q, k, v


def _gqa_logits(q, k):
    """q: (B,Sq,KV,G,hd), k: (B,Sk,KV,hd) -> (B,KV,G,Sq,Sk)."""
    return torch.einsum("bskgh,btkh->bkgst", q, k) / (q.shape[-1] ** 0.5)


def _gqa_out(probs, v):
    """probs: (B,KV,G,Sq,Sk), v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd)."""
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _proj_out(p: Attention, out):
    """out: (B,S,KV,G,hd) -> (B,S,D)."""
    return torch.einsum("bskgh,kghd->bsd", out, p.wo.to(out.dtype))


def attention_naive(q, k, v, kind, window, q_pos, kv_pos,
                    bidirectional=False):
    """q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd)."""
    logits = _gqa_logits(q, k).float()
    if bidirectional:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
    else:
        mask = _pair_mask(kind, window, q_pos, kv_pos)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


def attention_flash(q, k, v, kind: str = "full"):
    """Blockwise online-softmax attention through kernel B8
    (:func:`repro_torch.kernels.flash_attn.flash_attn`), positions 0 ..
    S-1 on both sides.  B8 masks causally or not at all, so only ``full``
    attention takes it; the local and chunked masks are ROADMAP A14."""
    if kind != "full":
        raise NotImplementedError(
            f"{kind} attention at S >= {FLASH_MIN_SEQ} needs a masked flash "
            f"kernel, not ported to repro_torch yet (ROADMAP A14)")
    return flash_attn(q, k, v, causal=True)


def attention_train(p: Attention, x, cfg: ModelConfig, kind, positions,
                    bidirectional=False):
    q, k, v = _qkv(p, x)
    if kind != "nope":  # llama4 global layers use NoPE; others get RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kind = "full" if kind == "nope" else kind
    S = x.shape[1]
    if S >= FLASH_MIN_SEQ and not bidirectional and S % FLASH_BLOCK == 0:
        out = attention_flash(q, k, v, kind)
    else:
        out = attention_naive(q, k, v, kind, cfg.window, positions,
                              positions, bidirectional=bidirectional)
    return _proj_out(p, out)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
class MLP(nn.Module):
    """``wi``/``wg (D, ff)`` and ``wo (ff, D)``; ``wg`` only for the gated
    kinds (swiglu, geglu)."""

    def __init__(self, wi, wo, wg=None):
        super().__init__()
        self.wi, self.wo = nn.Parameter(wi), nn.Parameter(wo)
        self.wg = None if wg is None else nn.Parameter(wg)


def init_mlp(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device) -> MLP:
    d, ff = cfg.d_model, cfg.d_ff

    def lin(din, dout):
        return init_linear(din, dout, generator=generator,
                           device=device).to(dtype)

    if cfg.mlp in ("swiglu", "geglu"):
        wi, wg, wo = lin(d, ff), lin(d, ff), lin(ff, d)
        return MLP(wi, wo, wg)
    if cfg.mlp in ("relu2", "gelu"):   # non-gated: minitron, granite
        return MLP(lin(d, ff), lin(ff, d))
    raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported to repro_torch "
                              f"yet (ROADMAP A14)")


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def mlp(p: MLP, x, kind: str):
    if kind == "swiglu":
        return linear(p.wo, F.silu(linear(p.wg, x)) * linear(p.wi, x))
    if kind == "geglu":
        return linear(p.wo, _gelu(linear(p.wg, x)) * linear(p.wi, x))
    if kind == "relu2":
        h = F.relu(linear(p.wi, x))
        return linear(p.wo, h * h)
    if kind == "gelu":
        return linear(p.wo, _gelu(linear(p.wi, x)))
    raise ValueError(kind)
