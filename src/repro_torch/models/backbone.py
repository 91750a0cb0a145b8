"""Decoder backbone of the dense LM families, train/prefill half.

The counterpart of the JAX package's ``models/backbone.py`` for dense
full-attention stacks (smollm, yi, minitron, granite): an ``LM`` module
holds the tied or untied embedding, the layers and the final norm;
:func:`forward` and :func:`lm_loss` are functions over it.  Layers follow
``cfg.layer_pattern`` cycled over ``cfg.n_layers``; where the reference
stacks each pattern group's parameters and scans over the groups, the
port keeps one module per layer and loops over them in Python (no remat:
the reference's LM driver trains with ``remat=False``).

Public surface:
  init_params(cfg, generator=, device=)  -> LM
  forward(params, cfg, tokens)           -> logits     train/prefill
  lm_loss(params, cfg, tokens, labels)   -> scalar
  params_from_jax(tree, cfg)             -> LM with the reference's weights

Decode, MoE, SSM and hybrid layers, and the VLM prefix are ROADMAP A14.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import (MLP, Attention, attention_train, init_attention,
                     init_mlp, mlp, rmsnorm)

__all__ = ["LM", "Layer", "group_layout", "init_params", "backbone_apply",
           "forward", "lm_loss", "params_from_jax"]

ATTN_KINDS = ("full", "local", "chunked")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Layer(nn.Module):
    """One attention layer: ``norm1``, ``attn``, ``norm2``, ``ffn``."""

    def __init__(self, norm1, attn: Attention, norm2, ffn: MLP):
        super().__init__()
        self.norm1, self.norm2 = nn.Parameter(norm1), nn.Parameter(norm2)
        self.attn, self.ffn = attn, ffn


class LM(nn.Module):
    """``embed (V, D)`` (the head too when tied), ``layers``,
    ``final_norm (D,)`` and, untied, ``lm_head (D, V)``."""

    def __init__(self, embed, layers: list[Layer], final_norm,
                 lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)


def _check_kind(cfg: ModelConfig, kind: str):
    if kind not in ATTN_KINDS or cfg.mlp == "moe":
        raise NotImplementedError(
            f"{kind!r} layers with mlp {cfg.mlp!r} ({cfg.family} family) "
            f"are not ported to repro_torch yet (ROADMAP A14)")


def _init_layer(cfg: ModelConfig, kind: str, *, generator, device) -> Layer:
    _check_kind(cfg, kind)
    dt = _dtype(cfg)
    zeros = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    return Layer(zeros, init_attention(cfg, dt, generator=generator,
                                       device=device),
                 zeros.clone(), init_mlp(cfg, dt, generator=generator,
                                         device=device))


def group_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...],
                                            tuple[str, ...]]:
    """(n_groups, group_kinds, rest_kinds)."""
    P = len(cfg.layer_pattern)
    n_groups, rest = divmod(cfg.n_layers, P)
    kinds = cfg.kinds()
    return n_groups, tuple(kinds[:P]), tuple(kinds[n_groups * P:])


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> LM:
    """Random weights with the JAX package's distributions: embed N(0, 1)
    * 0.02, the untied head N(0, 1) * d**-0.5, attention and MLP as in
    :mod:`.layers`, norms zero.  The draws differ from JAX's: a test that
    compares the two packages moves the JAX weights over with
    :func:`params_from_jax`."""
    for kind in cfg.kinds():
        _check_kind(cfg, kind)
    dt = _dtype(cfg)

    def nrm(shape, sc):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * sc).to(dt)

    embed = nrm((cfg.vocab, cfg.d_model), 0.02)
    head = (None if cfg.tie_embeddings
            else nrm((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5))
    layers = [_init_layer(cfg, kind, generator=generator, device=device)
              for kind in cfg.kinds()]
    return LM(embed, layers, torch.zeros((cfg.d_model,), dtype=torch.float32,
                                         device=device), head)


def _apply_layer(p: Layer, x, kind: str, cfg: ModelConfig, positions):
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    attn_kind = "nope" if (kind == "full" and cfg.nope_global) else kind
    x = x + attention_train(p.attn, h, cfg, attn_kind, positions)
    h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
    return x + mlp(p.ffn, h2, cfg.mlp)


def backbone_apply(params: LM, cfg: ModelConfig, x, positions):
    """Run all layers on embeddings x: (B,S,D) -> hidden (B,S,D)."""
    for layer, kind in zip(params.layers, cfg.kinds()):
        x = _apply_layer(layer, x, kind, cfg, positions)
    return x


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B,S) -> logits (B,S,V) in the model's dtype."""
    x = F.embedding(tokens, params.embed.to(_dtype(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)
    x = backbone_apply(params, cfg, x, positions)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


def lm_loss(params: LM, cfg: ModelConfig, tokens, labels):
    """Next-token cross-entropy over f32 logits (labels = tokens shifted
    by the caller; -1 = pad, masked)."""
    logits = forward(params, cfg, tokens).float()
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> LM:
    """A model that computes what the JAX package's ``forward`` computes
    with ``tree``: its ``init_params`` pytree with every leaf a numpy
    array (``{"embed", "final_norm", "groups": {"l{i}": ...}, "rest":
    {...}, "lm_head"}``, each group leaf stacked over the groups).  Layer
    ``g P + i`` is ``groups/l{i}`` at index ``g``; the rest follow.  One
    tied ``embed`` serves the gather and the head."""
    n_groups, gkinds, rkinds = group_layout(cfg)

    def layer(lp, kind, at=None):
        _check_kind(cfg, kind)
        t = (lambda a: _tensor(a if at is None else np.asarray(a)[at],
                               device))
        a, f = lp["attn"], lp["ffn"]
        attn = Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]))
        ffn = MLP(t(f["wi"]["w"]), t(f["wo"]["w"]),
                  t(f["wg"]["w"]) if "wg" in f else None)
        return Layer(t(lp["norm1"]), attn, t(lp["norm2"]), ffn)

    layers = [layer(tree["groups"][f"l{i}"], kind, g)
              for g in range(n_groups) for i, kind in enumerate(gkinds)]
    layers += [layer(tree["rest"][f"l{i}"], kind)
               for i, kind in enumerate(rkinds)]
    head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], device)
    return LM(_tensor(tree["embed"], device), layers,
              _tensor(tree["final_norm"], device), head)
