"""Core layers: the bias-free linear layer, RMSNorm, RoPE, GQA attention
for training (naive; at long sequences through kernel B8, or blockwise
for the masked kinds and other head widths) and for decode over a
ring-buffered KV cache, the dense MLPs and the sort-based MoE.

The counterpart of the JAX package's ``models/layers.py`` for the DLRM
and the LM: functions ``(params, x, ...) -> y`` over tensors, with
the JAX package's layouts (a linear weight is ``(din, dout)`` and the
forward ``x @ w``; attention weights keep the GQA head structure:
``wq (D, KV, G, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (KV, G, hd, D)``;
an MoE's experts are stacked, ``wi``/``wg (E, D, ff)``, ``wo (E, ff,
D)``).  :func:`cross_attention` is the audio decoder's attention over
the encoder's keys and values.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..dist import ctx
from ..kernels.flash_attn import HEAD_DIMS as B8_HEAD_DIMS
from ..kernels.flash_attn import flash_attn
from . import scan_config

__all__ = ["linear", "init_linear", "rmsnorm", "rope", "Attention",
           "init_attention", "attention_naive", "flash_route",
           "attention_blockwise", "attention_flash",
           "attention_train", "CacheSpec", "cache_spec", "init_kv_cache",
           "attention_decode", "cross_attention", "MLP", "init_mlp", "mlp",
           "MoE", "init_moe", "moe_ffn", "FLASH_MIN_SEQ", "FLASH_BLOCK"]

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
    """x: (B,S,D) -> q (B,S,KV,G,hd), k/v (B,S,KV,hd), under the mesh
    context's constraints (:func:`repro_torch.dist.ctx.constrain_qkv`)."""
    q = torch.einsum("bsd,dkgh->bskgh", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dkh->bskh", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dkh->bskh", x, p.wv.to(x.dtype))
    return ctx.constrain_qkv(q, k, v)


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


def flash_route(kind: str, hd: int) -> str:
    """The long-sequence route of :func:`attention_flash`: ``"b8"`` (the
    flash kernel, causal, positions 0 .. S-1) for ``full`` attention at a
    head width B8 takes, else ``"blockwise"`` (the reference's scan, for
    the local and chunked masks and any other hd).  Chosen by mask and hd
    only."""
    return "b8" if kind == "full" and hd in B8_HEAD_DIMS else "blockwise"


def attention_blockwise(q, k, v, kind: str, window: int, q_pos, kv_pos,
                        block: int = FLASH_BLOCK):
    """The reference's blockwise online-softmax attention (its
    ``attention_flash``): a loop over key blocks of ``block`` carrying the
    f32 running max ``m`` and sum ``l`` and the accumulator ``acc`` in q's
    dtype, the mask computed per block from the positions (never an (S,
    S) tensor), every block computed.  q: (B, Sq, KV, G, hd), k/v: (B,
    Sk, KV, hd) -> (B, Sq, KV, G, hd).  Autograd differentiates it."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    if Sk % block:
        raise ValueError(f"attention_blockwise needs Sk ({Sk}) a multiple "
                         f"of block ({block})")
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=q.dtype, device=q.device)
    for k0 in range(0, Sk, block):
        logits = torch.einsum("bskgh,btkh->bkgst", q,
                              k[:, k0:k0 + block]).float() / math.sqrt(hd)
        mask = _pair_mask(kind, window, q_pos, kv_pos[k0:k0 + block])
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(q.dtype),
                          v[:, k0:k0 + block])
        acc = acc * corr.permute(0, 3, 1, 2)[..., None].to(q.dtype) + pv
        m = m_new
    denom = l.permute(0, 3, 1, 2)[..., None]                   # (B,Sq,KV,G,1)
    return acc / torch.clamp(denom, min=1e-30).to(q.dtype)


def attention_flash(q, k, v, kind: str = "full", window: int = 0,
                    q_pos=None, kv_pos=None, block: int | None = None):
    """Long-sequence attention, by :func:`flash_route`: ``full`` at hd
    32, 64 or 128 through kernel B8
    (:func:`repro_torch.kernels.flash_attn.flash_attn`, causal, positions
    0 .. S-1 on both sides, ``block`` unused), every other mask and hd
    through :func:`attention_blockwise` at the given positions (0 .. S-1
    when None).  ``block`` None is ``FLASH_BLOCK``, or under
    ``scan_config.UNROLL`` (the dry run's cost probes) Sk //
    ``PROBE_INNER_STEPS`` when that is larger, as the reference's."""
    if flash_route(kind, q.shape[-1]) == "b8":
        return flash_attn(q, k, v, causal=True)
    if block is None:
        block = FLASH_BLOCK
        if scan_config.UNROLL:   # cost probes: fewer, bigger blocks
            block = max(FLASH_BLOCK,
                        k.shape[1] // scan_config.PROBE_INNER_STEPS)
    if q_pos is None:
        q_pos = torch.arange(q.shape[1], device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], device=q.device)
    return attention_blockwise(q, k, v, kind, window, q_pos, kv_pos, block)


def attention_train(p: Attention, x, cfg: ModelConfig, kind, positions,
                    bidirectional=False):
    q, k, v = _qkv(p, x)
    if kind != "nope":  # llama4 global layers use NoPE; others get RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kind = "full" if kind == "nope" else kind
    S = x.shape[1]
    if S >= FLASH_MIN_SEQ and not bidirectional and S % FLASH_BLOCK == 0:
        out = attention_flash(q, k, v, kind, cfg.window, positions,
                              positions)
    else:
        out = attention_naive(q, k, v, kind, cfg.window, positions,
                              positions, bidirectional=bidirectional)
    return _proj_out(p, out)


# --------------------------------------------------------------------------
# decode-time attention with a (ring-buffered) KV cache
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CacheSpec:
    size: int          # slots
    kind: str          # full | local | chunked


def cache_spec(kind: str, window: int, seq_len: int) -> CacheSpec:
    if kind in ("local", "chunked"):
        return CacheSpec(min(window, seq_len), kind)
    return CacheSpec(seq_len, "full")


def init_kv_cache(cfg: ModelConfig, spec: CacheSpec, batch: int, dtype,
                  device) -> dict:
    """``{k, v: (B, C, KV, hd) in dtype, pos: (C,) int32}``; ``pos`` is
    each slot's absolute position, -1 while the slot is empty."""
    shape = (batch, spec.size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((spec.size,), -1, dtype=torch.int32,
                              device=device)}


def attention_decode(p: Attention, x, cache: dict, cur_pos: int,
                     cfg: ModelConfig, kind: str):
    """x: (B, 1, D); ``cur_pos``: the new token's absolute position, a
    host int, so that neither the slot nor the mask reads the device.
    Writes the token's k, v and position into slot ``cur_pos % C`` of
    ``cache`` in place and returns ``(out (B, 1, D), cache)``."""
    q, k, v = _qkv(p, x)
    pos1 = torch.full((1,), cur_pos, dtype=torch.int32, device=x.device)
    if kind != "nope":
        q = rope(q, pos1, cfg.rope_theta)
        k = rope(k, pos1, cfg.rope_theta)
    kind = "full" if kind == "nope" else kind
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    C = ck.shape[1]
    slot = cur_pos % C
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    cpos[slot] = cur_pos
    logits = _gqa_logits(q, ck).float()                    # (B,KV,G,1,C)
    window = cfg.window if cfg.window else C
    valid = (cpos >= 0) & _pair_mask(kind, window, pos1, cpos)[0]   # (C,)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _proj_out(p, _gqa_out(probs, cv)), cache


def cross_attention(p: Attention, x, enc_k, enc_v):
    """Decoder -> encoder attention (whisper).  x: (B, S, D), enc_k/enc_v:
    (B, T, KV, hd) -> (B, S, D).  The query only is projected, without
    RoPE; every key is attended (no mask).  The logits are computed in
    x's dtype and cast to f32, the probabilities cast back to x's
    dtype, as the reference's."""
    q = torch.einsum("bsd,dkgh->bskgh", x, p.wq.to(x.dtype))
    logits = _gqa_logits(q, enc_k).float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    return _proj_out(p, _gqa_out(probs, enc_v))


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


# --------------------------------------------------------------------------
# MoE (sort-based grouped dispatch)
# --------------------------------------------------------------------------
class MoE(nn.Module):
    """``router (D, E)``, the stacked experts ``wi``/``wg (E, D, ff)`` and
    ``wo (E, ff, D)``, and for llama4 an always-on swiglu ``shared``
    expert (an :class:`MLP`)."""

    def __init__(self, router, wi, wg, wo, shared: MLP | None = None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.wi, self.wg = nn.Parameter(wi), nn.Parameter(wg)
        self.wo = nn.Parameter(wo)
        self.shared = shared


def init_moe(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device) -> MoE:
    """The JAX package's distributions: the router N(0, 1) * 0.02, the
    experts' ``wi``, ``wg`` N(0, 1) * d**-0.5 and ``wo`` N(0, 1) *
    ff**-0.5, the shared expert as :func:`init_mlp`'s swiglu."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def nrm(shape, sc):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * sc).to(dtype)

    shared = None
    if cfg.shared_expert:
        shared = init_mlp(dataclasses.replace(cfg, mlp="swiglu"), dtype,
                          generator=generator, device=device)
    return MoE(nrm((d, E), 0.02), nrm((E, d, ff), d ** -0.5),
               nrm((E, d, ff), d ** -0.5), nrm((E, ff, d), ff ** -0.5),
               shared)


def _moe_dispatch_block(xt, p: MoE, cfg: ModelConfig,
                        capacity_factor: float):
    """Sort-based capacity dispatch of one token block.  xt: (T, D) ->
    the (E, C, D) expert buffer, the (expert, token) pairs' metadata, the
    router's probabilities (T, E) and its top-k experts (T, K)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax((xt @ p.router.to(xt.dtype)).float(), dim=-1)
    # top-k as a stable descending sort: of two equal probabilities the
    # lower expert comes first, as jax.lax.top_k takes it
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    C = min(math.ceil(capacity_factor * T * K / E), T)
    eids = topi.reshape(-1)                               # (T*K,)
    tids = torch.arange(T, device=xt.device).repeat_interleave(K)
    w = topv.reshape(-1)

    order = torch.argsort(eids, stable=True)
    se, st, sw = eids[order], tids[order], w[order]
    grp_start = torch.searchsorted(se, torch.arange(E, device=xt.device))
    pos = torch.arange(T * K, device=xt.device) - grp_start[se]
    keep = pos < C
    slot = torch.where(keep, pos, C)          # dropped pairs: slot C
    buf = xt.new_zeros((E, C + 1, D)).index_put((se, slot), xt[st])[:, :C]
    return buf, (se, st, sw, pos, keep), probs, topi


def _moe_experts(p: MoE, buf, dtype):
    """The experts over an (..., E, C, D) buffer: one batched product a
    weight for every block."""
    hi = torch.einsum("...ecd,edf->...ecf", buf, p.wi.to(dtype))
    hg = torch.einsum("...ecd,edf->...ecf", buf, p.wg.to(dtype))
    return torch.einsum("...ecf,efd->...ecd", F.silu(hg) * hi,
                        p.wo.to(dtype))


def _moe_combine(ho, meta, T: int, D: int, dtype):
    """Each pair's expert output, weighted by its router probability (0
    for a dropped pair), added into its token's row.  A token has K <= 2
    pairs added to a zero row, and a sum of two terms is the same in
    either order, so the card's atomic adds are deterministic here."""
    se, st, sw, pos, keep = meta
    contrib = ho[se, torch.where(keep, pos, 0)] \
        * (sw * keep)[:, None].to(dtype)
    return ho.new_zeros((T, D)).index_add(0, st, contrib)


def moe_ffn(p: MoE, x, cfg: ModelConfig, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (y (B, S, D), aux).  The tokens' (expert, token)
    pairs are sorted by expert and packed into an (E, C, D) buffer, C =
    min(ceil(capacity_factor T K / E), T) (pairs past an expert's
    capacity are dropped), the experts run as batched products over the
    stacked weights, and the outputs are added back weighted by the
    router's renormalised top-k probabilities.  ``aux`` is the Switch
    load-balance loss E * sum(mean prob * top-1 share).

    With ``dist.ctx.MOE_BLOCKS = nb > 1`` dividing T the tokens split
    into nb blocks of T // nb, each dispatched and combined on its own
    (its own capacity C from T // nb), the experts run once over the
    (nb, E, C, D) buffer, and the router's probabilities and top-k come
    back to (T, ...) for the aux loss, as the reference's blocks (its
    ``vmap``).  ``MOE_BLOCK_SPECS``, the blocks' sharding constraints,
    are the identity on one card."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, D)
    nb = ctx.MOE_BLOCKS if ctx.MOE_BLOCKS > 1 and T % ctx.MOE_BLOCKS == 0 \
        else 1
    if nb > 1:
        blocks = [_moe_dispatch_block(xb, p, cfg, capacity_factor)
                  for xb in xt.reshape(nb, T // nb, D)]
        ho = _moe_experts(p, torch.stack([b[0] for b in blocks]), xt.dtype)
        yt = torch.cat([_moe_combine(ho[i], b[1], T // nb, D, xt.dtype)
                        for i, b in enumerate(blocks)])
        probs = torch.cat([b[2] for b in blocks])
        topi = torch.cat([b[3] for b in blocks])
    else:
        buf, meta, probs, topi = _moe_dispatch_block(xt, p, cfg,
                                                     capacity_factor)
        yt = _moe_combine(_moe_experts(p, buf, xt.dtype), meta, T, D,
                          xt.dtype)
    if p.shared is not None:
        yt = yt + mlp(p.shared, xt, "swiglu")
    me = probs.mean(dim=0)                                # (E,)
    fe = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * fe)
    return yt.reshape(B, S, D), aux
