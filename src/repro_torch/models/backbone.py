"""Decoder backbone of the LM families (dense, MoE, SSM, hybrid and the
VLM's decoder): train, prefill and decode.

The counterpart of the JAX package's ``models/backbone.py``: attention
stacks (smollm, yi, minitron, granite; phi3.5-moe and llama4-scout with
their MoE layers), Mamba stacks (falcon-mamba), RG-LRU layers beside
local attention (recurrentgemma), and pixtral's decoder, whose stub
patch embeddings are fused in front of the tokens (``prefix_embeds``).
An ``LM`` module holds the tied or untied embedding, the layers and the
final norm; :func:`forward`, :func:`lm_loss` and :func:`decode_step`
are functions over it.  Layers follow ``cfg.layer_pattern`` cycled
over ``cfg.n_layers``; where the reference stacks each pattern group's
parameters and scans over the groups, the port keeps one module per
layer and loops over them in Python (:func:`.scan_config.scan_apply`).
With ``remat`` (the reference's default; its LM driver passes
``False``) each group of ``len(cfg.layer_pattern)`` layers runs under
one activation checkpoint (:func:`remat_call`): autograd keeps the
group's input and recomputes its forward in the backward; the ``rest``
layers are not checkpointed, and without autograd (prefill) ``remat``
changes nothing.  The decode cache is a list with one dict a layer: a
KV cache for attention, the conv window and state for ``mamba`` and
``rglru``.

Public surface:
  init_params(cfg, generator=, device=)  -> LM
  forward(params, cfg, tokens, prefix_embeds=None, remat=True)
                                         -> (logits, aux) train/prefill
  lm_loss(params, cfg, tokens, labels, prefix_embeds=None, remat=True)
                                         -> scalar (+ 0.01 aux for MoE)
  init_cache(cfg, batch, seq_len, device) -> decode cache
  decode_step(params, cfg, token, cache, pos) -> (logits, cache)
  params_from_jax(tree, cfg)             -> LM with the reference's weights
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ModelConfig
from . import ssm
from .scan_config import scan_apply
from .layers import (MLP, Attention, MoE, attention_decode,
                     attention_train, cache_spec, init_attention,
                     init_kv_cache, init_mlp, init_moe, mlp, moe_ffn,
                     rmsnorm)
from .tree import to_numpy, to_ref

__all__ = ["LM", "Layer", "group_layout", "init_params", "remat_call",
           "backbone_apply",
           "forward", "lm_loss", "token_cross_entropy", "init_cache",
           "decode_step", "params_from_jax", "ref_paths", "params_to_jax"]

ATTN_KINDS = ("full", "local", "chunked")
KINDS = ATTN_KINDS + ("mamba", "rglru")
# the recurrent layers' mixers: kind -> (attribute and reference name,
# module)
_MIXERS = {"mamba": ("mamba", ssm.Mamba), "rglru": ("rec", ssm.RGLRU)}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Layer(nn.Module):
    """One layer: ``norm1`` and its mixer, then ``norm2`` and ``ffn`` (an
    :class:`MLP`, or an :class:`MoE` when ``cfg.mlp`` is ``moe``).  The
    mixer is ``attn`` (an :class:`Attention`), ``rec`` (an
    :class:`~.ssm.RGLRU`) or ``mamba`` (a :class:`~.ssm.Mamba`, whose
    layer has no FFN half: ``norm2`` and ``ffn`` None)."""

    def __init__(self, norm1, mixer: Attention | ssm.RGLRU | ssm.Mamba,
                 norm2=None, ffn: MLP | MoE | None = None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1)
        self.norm2 = None if norm2 is None else nn.Parameter(norm2)
        name = next((n for n, cls in _MIXERS.values()
                     if isinstance(mixer, cls)), "attn")
        setattr(self, name, mixer)
        self.ffn = ffn


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
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r} ({cfg.name})")


def _init_layer(cfg: ModelConfig, kind: str, *, generator, device) -> Layer:
    _check_kind(cfg, kind)
    dt = _dtype(cfg)
    zeros = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    if kind == "mamba":
        return Layer(zeros, ssm.init_mamba(cfg, dt, generator=generator,
                                           device=device))
    init_mixer = ssm.init_rglru if kind == "rglru" else init_attention
    mixer = init_mixer(cfg, dt, generator=generator, device=device)
    init_ffn = init_moe if cfg.mlp == "moe" else init_mlp
    return Layer(zeros, mixer, zeros.clone(),
                 init_ffn(cfg, dt, generator=generator, device=device))


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


def _attn_kind(cfg: ModelConfig, kind: str) -> str:
    # llama4's global layers skip RoPE (NoPE)
    return "nope" if (kind == "full" and cfg.nope_global) else kind


def _ffn(p: Layer, x, cfg: ModelConfig):
    """The layer's feed-forward half on x: (x', aux); aux is None for a
    dense MLP."""
    h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
    if cfg.mlp == "moe":
        y, aux = moe_ffn(p.ffn, h2, cfg)
        return x + y, aux
    return x + mlp(p.ffn, h2, cfg.mlp), None


def _apply_layer(p: Layer, x, kind: str, cfg: ModelConfig, positions):
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind == "mamba":
        return x + ssm.mamba_block(p.mamba, h, cfg), None
    if kind == "rglru":
        x = x + ssm.rglru_block(p.rec, h, cfg)
    else:
        x = x + attention_train(p.attn, h, cfg, _attn_kind(cfg, kind),
                                positions)
    return _ffn(p, x, cfg)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under an activation checkpoint when ``remat`` and
    autograd is on (the reference's ``jax.checkpoint``): the backward
    recomputes ``fn``'s forward from ``args`` instead of keeping its
    activations.  Without autograd it is the plain call."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def backbone_apply(params: LM, cfg: ModelConfig, x, positions,
                   remat: bool = True):
    """Run all layers on embeddings x: (B,S,D) -> (hidden (B,S,D), aux),
    aux the f32 sum of the MoE layers' load-balance losses (0 without
    MoE).  The grouped layers run a group at a time, each group under
    one checkpoint with ``remat``, carrying ``(x, aux)``; the ``rest``
    layers follow unchecked, as the reference's."""
    n_groups, gkinds, rkinds = group_layout(cfg)
    P = len(gkinds)
    layers = list(params.layers)

    def run(at: int, kinds, h, aux):
        for i, kind in enumerate(kinds):
            h, a = _apply_layer(layers[at + i], h, kind, cfg, positions)
            if a is not None:
                aux = aux + a
        return h, aux

    def group_body(carry, g):
        return remat_call(remat, run, int(g) * P, gkinds, *carry), None

    carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    if n_groups:
        carry, _ = scan_apply(group_body, carry, torch.arange(n_groups))
    return run(n_groups * P, rkinds, *carry)


def _head(params: LM, cfg: ModelConfig, x):
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True):
    """tokens: (B,S) -> (logits (B,P+S,V) in the model's dtype, aux).

    ``prefix_embeds`` (B,P,D), the VLM's stub patch embeddings, are cast
    to the embeddings' dtype and fused in front of the tokens; positions
    run 0 .. P+S-1, and P+S decides the attention route."""
    x = F.embedding(tokens, params.embed.to(_dtype(cfg)))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = backbone_apply(params, cfg, x, positions, remat=remat)
    return _head(params, cfg, x), aux


def lm_loss(params: LM, cfg: ModelConfig, tokens, labels,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True):
    """Next-token cross-entropy over f32 logits (labels = tokens shifted
    by the caller; -1 = pad, masked), plus the router's aux loss with
    weight 0.01.  With ``prefix_embeds`` (B,P,D) the loss is over the
    text positions only (the logits' last S)."""
    logits, aux = forward(params, cfg, tokens, prefix_embeds, remat=remat)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    return token_cross_entropy(logits.float(), labels) + 0.01 * aux


def token_cross_entropy(logits, labels):
    """The mean of ``-log softmax(logits)[label]`` over the labels >= 0
    (-1 = pad), in the logits' dtype."""
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


# --------------------------------------------------------------------------
# decode (serve step)
# --------------------------------------------------------------------------
def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int, device) -> dict:
    _check_kind(cfg, kind)
    dt = _dtype(cfg)
    if kind == "mamba":
        return ssm.init_mamba_cache(cfg, batch, dt, device)
    if kind == "rglru":
        return ssm.init_rglru_cache(cfg, batch, dt, device)
    return init_kv_cache(cfg, cache_spec(kind, cfg.window, seq_len), batch,
                         dt, device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> list:
    """One cache a layer: a KV cache (:func:`.layers.init_kv_cache`) of
    ``seq_len`` slots for full attention and ``min(window, seq_len)`` for
    local and chunked layers; the conv window and the f32 state for
    ``mamba`` and ``rglru`` layers (:mod:`.ssm`)."""
    return [_init_layer_cache(cfg, kind, batch, seq_len, device)
            for kind in cfg.kinds()]


def _apply_layer_decode(p: Layer, x, kind: str, cfg: ModelConfig,
                        layer_cache: dict, pos: int):
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind == "mamba":
        y, layer_cache = ssm.mamba_step(p.mamba, h, layer_cache, cfg)
        return x + y, layer_cache
    if kind == "rglru":
        y, layer_cache = ssm.rglru_step(p.rec, h, layer_cache, cfg)
    else:
        y, layer_cache = attention_decode(p.attn, h, layer_cache, pos, cfg,
                                          _attn_kind(cfg, kind))
    x, _ = _ffn(p, x + y, cfg)
    return x, layer_cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, cache: list, pos: int):
    """token: (B, 1) int; ``pos``: the token's absolute position, a host
    int.  -> (logits (B, 1, V), cache), each layer's cache written in
    place.  Runs without autograd: a cache written in place must not
    carry a graph from step to step."""
    x = F.embedding(token, params.embed.to(_dtype(cfg)))
    for i, (layer, kind) in enumerate(zip(params.layers, cfg.kinds())):
        x, cache[i] = _apply_layer_decode(layer, x, kind, cfg, cache[i], pos)
    return _head(params, cfg, x), cache


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
    tied ``embed`` serves the gather and the head.  An MoE layer's
    ``ffn`` is ``{router/w, wi, wg, wo}``, with ``shared/{wi,wg,wo}/w``
    for llama4; a ``mamba`` layer is ``{norm1, mamba}``, an ``rglru``
    layer's mixer ``rec``, their linears ``{"w"}`` leaves."""
    n_groups, gkinds, rkinds = group_layout(cfg)

    def layer(lp, kind, at=None):
        _check_kind(cfg, kind)
        t = (lambda a: _tensor(a if at is None else np.asarray(a)[at],
                               device))
        if kind in _MIXERS:
            name, cls = _MIXERS[kind]
            mp = lp[name]
            mixer = cls(**{n: t(mp[n]["w"] if n in cls.LINEARS else mp[n])
                           for n in cls.LEAVES})
            if kind == "mamba":
                return Layer(t(lp["norm1"]), mixer)
        else:
            a = lp["attn"]
            mixer = Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]))
        f = lp["ffn"]

        def dense(f):
            return MLP(t(f["wi"]["w"]), t(f["wo"]["w"]),
                       t(f["wg"]["w"]) if "wg" in f else None)

        if cfg.mlp == "moe":
            ffn = MoE(t(f["router"]["w"]), t(f["wi"]), t(f["wg"]),
                      t(f["wo"]), dense(f["shared"]) if "shared" in f
                      else None)
        else:
            ffn = dense(f)
        return Layer(t(lp["norm1"]), mixer, t(lp["norm2"]), ffn)

    layers = [layer(tree["groups"][f"l{i}"], kind, g)
              for g in range(n_groups) for i, kind in enumerate(gkinds)]
    layers += [layer(tree["rest"][f"l{i}"], kind)
               for i, kind in enumerate(rkinds)]
    head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], device)
    return LM(_tensor(tree["embed"], device), layers,
              _tensor(tree["final_norm"], device), head)


def ref_paths(model: LM, cfg: ModelConfig) -> list:
    """Each of ``model.parameters()``'s place in the JAX package's tree
    (:mod:`repro_torch.models.tree`): layer ``g P + i`` of the grouped
    layers at index ``g`` of ``groups/l{i}/...``, the rest under
    ``rest/l{j}/...``; a dense FFN's matrices and the SSM mixers'
    linears as ``{"w"}`` leaves, an MoE layer's router as ``router/w``
    beside its expert stacks."""
    n_groups, gkinds, _ = group_layout(cfg)
    P = len(gkinds)
    mixers = dict(_MIXERS.values())
    paths = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            paths.append(((parts[0],), None))
            continue
        j, rest = int(parts[1]), parts[2:]
        if rest[0] == "ffn" and (cfg.mlp != "moe" or rest[1] in ("router",
                                                                 "shared")):
            rest = rest + ["w"]
        elif rest[0] in mixers and rest[1] in mixers[rest[0]].LINEARS:
            rest = rest + ["w"]
        if j < n_groups * P:
            paths.append((("groups", f"l{j % P}", *rest), j // P))
        else:
            paths.append((("rest", f"l{j - n_groups * P}", *rest), None))
    return paths


def params_to_jax(model: LM, cfg: ModelConfig) -> dict:
    """:func:`params_from_jax`'s inverse: the JAX package's
    ``init_params`` pytree of ``model``'s weights, as numpy (bf16 leaves
    as f32)."""
    return to_numpy(to_ref(list(model.parameters()), ref_paths(model, cfg)))
