"""Whisper-style encoder-decoder: the audio family (whisper-large-v3).

The counterpart of the JAX package's ``models/whisper.py``.  The
mel-spectrogram and conv feature extractor is a stub: the caller gives
frame embeddings (B, S_frames, D) that already carry their positions.
The transformer encoder is bidirectional (the naive attention route at
any length, as the reference's); the decoder runs causal
self-attention, cross-attention to the encoder's memory and the MLP,
with a tied head.  Decode keeps a self-KV ring of ``DEC_CTX`` slots a
layer and cross K/V of the encoder's length.

The reference stacks the encoder's and the decoder's layer parameters
on a leading axis and scans over them; the port keeps one module a
layer and loops in Python (:func:`.scan_config.scan_apply`).  With
``remat`` (the reference's default) every encoder layer and every
decoder layer runs under its own activation checkpoint
(:func:`.backbone.remat_call`; a decoder layer's cross K/V of the
memory are recomputed with it); without autograd it changes
nothing.

Public surface:
  init_params(cfg, generator=, device=)        -> Whisper
  encode(params, cfg, frames, remat=True)      -> memory (B, T, D)
  decode_train(params, cfg, tokens, memory, remat=True)
                                               -> logits (B, S_dec, V)
  loss(params, cfg, frames, tokens, labels, remat=True) -> scalar
  init_cache(cfg, batch, enc_len, device)      -> decode cache
  fill_cross_kv(params, cfg, cache, memory)    -> cache (cross K/V set)
  decode_step(params, cfg, token, cache, pos)  -> (logits, cache)
  params_from_jax(tree, cfg), params_to_jax(model, cfg), ref_paths(...)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .backbone import (Layer, _dtype, _tensor, remat_call,
                       token_cross_entropy)
from .layers import (MLP, Attention, attention_decode, attention_train,
                     cache_spec, cross_attention, init_attention,
                     init_kv_cache, init_mlp, mlp, rmsnorm)
from .scan_config import scan_apply
from .tree import to_numpy, to_ref

__all__ = ["DEC_CTX", "DecLayer", "Whisper", "init_params", "encode",
           "decode_train", "loss", "init_cache", "fill_cross_kv",
           "decode_step", "params_from_jax", "ref_paths", "params_to_jax"]

DEC_CTX = 448  # whisper decoder max positions


class DecLayer(nn.Module):
    """A decoder layer: ``norm1`` and ``attn`` (causal self-attention),
    ``norm_x`` and ``xattn`` (cross-attention: its ``wq`` and ``wo`` act
    on the decoder's tokens, its ``wk`` and ``wv`` on the encoder's
    memory, :func:`_enc_kv`), ``norm2`` and ``ffn``."""

    def __init__(self, norm1, attn: Attention, norm_x, xattn: Attention,
                 norm2, ffn: MLP):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.attn = attn
        self.norm_x = nn.Parameter(norm_x)
        self.xattn = xattn
        self.norm2 = nn.Parameter(norm2)
        self.ffn = ffn


class Whisper(nn.Module):
    """``embed (V, D)`` (the tied head too), the encoder's layers ``enc``
    (:class:`~.backbone.Layer`: ``norm1``, ``attn``, ``norm2``, ``ffn``),
    the decoder's ``dec`` (:class:`DecLayer`), ``enc_norm`` and
    ``final_norm (D,)``."""

    def __init__(self, embed, enc: list[Layer], dec: list[DecLayer],
                 enc_norm, final_norm):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.enc_norm = nn.Parameter(enc_norm)
        self.final_norm = nn.Parameter(final_norm)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Whisper:
    """Random weights with the JAX package's distributions: embed N(0, 1)
    * 0.02, attention and MLP as in :mod:`.layers`, norms zero.  The
    draws differ from JAX's: a test that compares the two packages moves
    the JAX weights over with :func:`params_from_jax`."""
    dt = _dtype(cfg)
    kw = dict(generator=generator, device=device)

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=device)

    embed = (torch.randn((cfg.vocab, cfg.d_model), dtype=torch.float32,
                         **kw) * 0.02).to(dt)
    enc = [Layer(zeros(), init_attention(cfg, dt, **kw), zeros(),
                 init_mlp(cfg, dt, **kw))
           for _ in range(cfg.encoder_layers)]
    dec = [DecLayer(zeros(), init_attention(cfg, dt, **kw), zeros(),
                    init_attention(cfg, dt, **kw), zeros(),
                    init_mlp(cfg, dt, **kw))
           for _ in range(cfg.n_layers)]
    return Whisper(embed, enc, dec, zeros(), zeros())


def encode(params: Whisper, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = True):
    """frames: (B, S, D) stub frame embeddings -> (B, S, D) memory in the
    model's dtype.  Bidirectional self-attention: the naive route at
    every S, as the reference's route rule sends it."""
    positions = torch.arange(frames.shape[1], device=frames.device)

    def layer(lp: Layer, x):
        h = rmsnorm(x, lp.norm1, cfg.norm_eps)
        x = x + attention_train(lp.attn, h, cfg, "full", positions,
                                bidirectional=True)
        h = rmsnorm(x, lp.norm2, cfg.norm_eps)
        return x + mlp(lp.ffn, h, cfg.mlp)

    def body(x, i):
        return remat_call(remat, layer, params.enc[int(i)], x), None

    x, _ = scan_apply(body, frames.to(_dtype(cfg)),
                      torch.arange(len(params.enc)))
    return rmsnorm(x, params.enc_norm, cfg.norm_eps)


def _enc_kv(lp: DecLayer, memory: torch.Tensor, cfg: ModelConfig):
    """The layer's cross K/V of the memory: (B, T, KV, hd) each."""
    k = torch.einsum("btd,dkh->btkh", memory, lp.xattn.wk.to(memory.dtype))
    v = torch.einsum("btd,dkh->btkh", memory, lp.xattn.wv.to(memory.dtype))
    return k, v


def decode_train(params: Whisper, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor, remat: bool = True):
    """tokens: (B, S_dec) -> logits (B, S_dec, V) in the model's dtype."""
    x = F.embedding(tokens, params.embed.to(_dtype(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(lp: DecLayer, x, memory):
        h = rmsnorm(x, lp.norm1, cfg.norm_eps)
        x = x + attention_train(lp.attn, h, cfg, "full", positions)
        h = rmsnorm(x, lp.norm_x, cfg.norm_eps)
        x = x + cross_attention(lp.xattn, h, *_enc_kv(lp, memory, cfg))
        h = rmsnorm(x, lp.norm2, cfg.norm_eps)
        return x + mlp(lp.ffn, h, cfg.mlp)

    def body(x, i):
        return remat_call(remat, layer, params.dec[int(i)], x, memory), None

    x, _ = scan_apply(body, x, torch.arange(len(params.dec)))
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ params.embed.T.to(x.dtype)


def loss(params: Whisper, cfg: ModelConfig, frames, tokens, labels,
         remat: bool = True):
    """Cross-entropy of the decoder's f32 logits (-1 labels masked)."""
    memory = encode(params, cfg, frames, remat=remat)
    logits = decode_train(params, cfg, tokens, memory, remat=remat).float()
    return token_cross_entropy(logits, labels)


def init_cache(cfg: ModelConfig, batch: int, enc_len: int, device) -> dict:
    """``{"self": one KV ring of DEC_CTX slots a decoder layer,
    "cross_k", "cross_v": (L, B, enc_len, KV, hd) zeros}`` in the
    model's dtype, as the reference's (no reference function fills the
    cross K/V; :func:`fill_cross_kv` does)."""
    dt = _dtype(cfg)
    spec = cache_spec("full", 0, DEC_CTX)
    shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    return {"self": [init_kv_cache(cfg, spec, batch, dt, device)
                     for _ in range(cfg.n_layers)],
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def fill_cross_kv(params: Whisper, cfg: ModelConfig, cache: dict,
                  memory: torch.Tensor) -> dict:
    """Write each decoder layer's cross K/V of ``memory`` (B, enc_len, D),
    as :func:`decode_train` computes them, into ``cache`` in place."""
    for i, lp in enumerate(params.dec):
        cache["cross_k"][i], cache["cross_v"][i] = _enc_kv(lp, memory, cfg)
    return cache


@torch.no_grad()
def decode_step(params: Whisper, cfg: ModelConfig, token, cache: dict,
                pos: int):
    """One decoder token against the cached cross K/V.  token: (B, 1)
    int; ``pos`` a host int (slot ``pos % DEC_CTX`` of the ring; past
    ``DEC_CTX`` the ring keeps the last ``DEC_CTX`` positions).  ->
    (logits (B, 1, V), cache), the self-KV rings written in place."""
    x = F.embedding(token, params.embed.to(_dtype(cfg)))
    for i, lp in enumerate(params.dec):
        h = rmsnorm(x, lp.norm1, cfg.norm_eps)
        y, cache["self"][i] = attention_decode(lp.attn, h, cache["self"][i],
                                               pos, cfg, "full")
        x = x + y
        h = rmsnorm(x, lp.norm_x, cfg.norm_eps)
        x = x + cross_attention(lp.xattn, h, cache["cross_k"][i],
                                cache["cross_v"][i])
        h = rmsnorm(x, lp.norm2, cfg.norm_eps)
        x = x + mlp(lp.ffn, h, cfg.mlp)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ params.embed.T.to(x.dtype), cache


def params_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> Whisper:
    """A model that computes what the JAX package's whisper computes with
    ``tree``, its ``init_params`` pytree with numpy leaves: ``{"embed",
    "enc", "dec", "enc_norm", "final_norm"}``, each ``enc`` and ``dec``
    leaf stacked over the layers; an MLP's matrices are ``{"w"}``
    leaves."""
    def t(a, i=None):
        return _tensor(a if i is None else np.asarray(a)[i], device)

    def attn(a, i):
        return Attention(t(a["wq"], i), t(a["wk"], i), t(a["wv"], i),
                         t(a["wo"], i))

    def ffn(f, i):
        return MLP(t(f["wi"]["w"], i), t(f["wo"]["w"], i),
                   t(f["wg"]["w"], i) if "wg" in f else None)

    e, d = tree["enc"], tree["dec"]
    enc = [Layer(t(e["norm1"], i), attn(e["attn"], i), t(e["norm2"], i),
                 ffn(e["ffn"], i)) for i in range(cfg.encoder_layers)]
    dec = [DecLayer(t(d["norm1"], i), attn(d["attn"], i), t(d["norm_x"], i),
                    attn(d["xattn"], i), t(d["norm2"], i), ffn(d["ffn"], i))
           for i in range(cfg.n_layers)]
    return Whisper(t(tree["embed"]), enc, dec, t(tree["enc_norm"]),
                   t(tree["final_norm"]))


def ref_paths(model: Whisper, cfg: ModelConfig) -> list:
    """Each of ``model.parameters()``'s place in the JAX package's tree
    (:mod:`repro_torch.models.tree`): encoder layer ``i`` at index ``i``
    of ``enc/...``, decoder layer ``i`` of ``dec/...``, an MLP's
    matrices as ``{"w"}`` leaves."""
    paths = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] not in ("enc", "dec"):
            paths.append(((parts[0],), None))
            continue
        rest = parts[2:] + (["w"] if parts[2] == "ffn" else [])
        paths.append(((parts[0], *rest), int(parts[1])))
    return paths


def params_to_jax(model: Whisper, cfg: ModelConfig) -> dict:
    """:func:`params_from_jax`'s inverse: the JAX package's
    ``init_params`` pytree of ``model``'s weights, as numpy (bf16 leaves
    as f32)."""
    return to_numpy(to_ref(list(model.parameters()), ref_paths(model, cfg)))
