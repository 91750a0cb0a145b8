"""DLRM models for the paper's workloads: WDL [12], DeepFM [24], DCN [66].

One flat embedding table over the concatenated field vocabularies (ids are
pre-offset by the data pipeline).  Dense features go through the bottom
MLP; interaction is model-specific (wide linear / FM / cross network); the
top MLP emits the CTR logit.  The arithmetic mirrors the JAX package's
``models/dlrm.py`` step for step; the MLP products are plain ``@``.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..configs.dlrm_configs import DLRMConfig
from ..data.synthetic import WORKLOADS, CTRWorkload
from .layers import init_linear, linear
from .tree import to_numpy, to_ref

__all__ = ["DLRM", "init_params", "params_from_jax", "ref_paths",
           "params_to_jax", "ps_stack_tables", "bce_loss",
           "bce_loss_masked", "train_step"]


def _flat_table(tbl: torch.Tensor) -> torch.Tensor:
    """A lookup view of a table: PS-stacked (n_ps, max_rows, E) flattens
    so PS-linearized ids index it directly; flat (V, E) passes through."""
    return tbl.reshape(-1, tbl.shape[-1]) if tbl.dim() == 3 else tbl


def _mlp(layers, x):
    for i, w in enumerate(layers):
        x = linear(w, x)
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


class DLRM(nn.Module):
    """WDL / DFM / DCN over one flat ``(V, E)`` embedding table, or its
    PS stack (:func:`ps_stack_tables`).

    Weights keep the JAX package's layout: MLP weights ``(din, dout)``,
    ``wide`` ``(V, 1)`` (wdl), ``cross_w``/``cross_b`` ``(L, d)`` (dcn);
    a PS-stacked ``embed`` and ``wide`` are ``(n_ps, max_rows, E)`` and
    ``(n_ps, max_rows, 1)``.
    The parameters are built frozen, for serving; the training driver
    makes them trainable with ``model.requires_grad_(True)``, and the
    embedding gather then gives a dense ``(V, E)`` gradient, as JAX's.
    """

    def __init__(self, cfg: DLRMConfig, embed: torch.Tensor, bottom, top,
                 wide: torch.Tensor | None = None,
                 cross_w: torch.Tensor | None = None,
                 cross_b: torch.Tensor | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.bottom = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in bottom])
        self.top = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in top])
        need = {"wdl": ("wide",), "dfm": (), "dcn": ("cross_w", "cross_b")}
        given = {"wide": wide, "cross_w": cross_w, "cross_b": cross_b}
        for name, t in given.items():
            if (t is not None) != (name in need[cfg.kind]):
                verb = "needs" if t is None else "takes no"
                raise ValueError(f"{cfg.kind} {verb} {name}")
            setattr(self, name, None if t is None
                    else nn.Parameter(t, requires_grad=False))

    def forward(self, sparse_ids: torch.Tensor, dense: torch.Tensor,
                n_fields: int | None = None,
                emb_all: torch.Tensor | None = None) -> torch.Tensor:
        """sparse_ids: (B, W) flat ids (W = fixed fields + multi-hot
        history slots, PAD=-1); dense: (B, n_dense) -> logits (B,).

        Multi-PS: with PS-stacked tables the ids are PS-linearized, and
        the stack flattens so row ``p * max_rows + local`` is PS ``p``'s
        ``local`` row.

        ``emb_all`` injects pre-gathered (B, W, E) embedding rows (PAD rows
        already zeroed) in place of the table gather — the serving path
        reads rows from its TTL cache plane and runs the identical
        interaction stack.
        """
        cfg = self.cfg
        F = n_fields if n_fields is not None else WORKLOADS[cfg.workload].n_fields
        F = min(F, sparse_ids.shape[1])
        valid = sparse_ids >= 0
        ids = torch.where(valid, sparse_ids, 0).long()
        if emb_all is None:
            emb_all = _flat_table(self.embed)[ids] * valid[..., None]
        fields = emb_all[:, :F]
        hist = emb_all[:, F:]
        hn = valid[:, F:].sum(dim=1, keepdim=True).clamp(min=1)
        pooled = hist.sum(dim=1) / hn                          # (B, E)
        emb = torch.cat([fields, pooled[:, None]], dim=1)      # (B, F+1, E)
        d = _mlp(self.bottom, dense)                           # (B, E)

        denom = valid.sum(dim=1, keepdim=True).clamp(min=1)
        if cfg.kind == "wdl":
            deep_in = emb_all.sum(dim=1) / denom + d
            deep = _mlp(self.top, deep_in)[:, 0]
            wide = (_flat_table(self.wide)[ids][..., 0] * valid).sum(dim=1)
            return deep + wide
        if cfg.kind == "dfm":
            # FM second-order via the sum-square trick (fields + pooled + dense)
            feats = torch.cat([emb, d[:, None, :]], dim=1)     # (B, F+2, E)
            s = feats.sum(dim=1)
            fm = 0.5 * (s * s - (feats * feats).sum(dim=1)).sum(dim=-1)
            first = emb_all.sum(dim=(1, 2))
            deep = _mlp(self.top, emb_all.sum(dim=1) / denom + d)[:, 0]
            return deep + fm + first
        if cfg.kind == "dcn":
            x0 = torch.cat([emb.reshape(emb.shape[0], -1), d], dim=-1)
            x = x0
            for l in range(cfg.cross_layers):
                xw = x @ self.cross_w[l]                       # (B,)
                x = x0 * xw[:, None] + self.cross_b[l][None] + x
            return _mlp(self.top, x)[:, 0]
        raise ValueError(cfg.kind)


def _init_mlp(din, dims, generator, device):
    layers = []
    for dout in dims:
        layers.append(init_linear(din, dout, generator=generator,
                                  device=device))
        din = dout
    return layers


def init_params(cfg: DLRMConfig, workload: CTRWorkload,
                generator: torch.Generator, device) -> DLRM:
    """Random weights with the JAX package's distributions: tables
    N(0, 1) * 0.01, MLP weights N(0, 1) * din**-0.5, ``cross_w`` N(0, 1) *
    d**-0.5 and ``cross_b`` zero.  The draws differ from JAX's: a test
    that compares the two packages moves the JAX weights over with
    :func:`params_from_jax`."""
    V, E = workload.vocab, cfg.embedding_dim
    F = workload.n_fields

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    embed = normal(V, E) * 0.01
    bottom = _init_mlp(workload.n_dense, (*cfg.mlp_dims, E), generator,
                       device)
    # interaction blocks: F single-hot fields + 1 pooled multi-hot history
    # bag + 1 dense projection
    inter_dim = {"wdl": E, "dfm": E, "dcn": E * (F + 2)}[cfg.kind]
    top = _init_mlp(inter_dim, (*cfg.mlp_dims, 1), generator, device)
    extra = {}
    if cfg.kind == "wdl":
        extra["wide"] = normal(V, 1) * 0.01
    if cfg.kind == "dcn":
        d = E * (F + 2)
        extra["cross_w"] = normal(cfg.cross_layers, d) * (d ** -0.5)
        extra["cross_b"] = torch.zeros((cfg.cross_layers, d),
                                       dtype=torch.float32, device=device)
    return DLRM(cfg, embed, bottom, top, **extra)


def ps_stack_tables(model: DLRM, part) -> DLRM:
    """The model with its flat (V, ...) tables re-homed onto
    ``part.n_ps`` parameter servers: rows permute into the
    :mod:`repro_torch.ps` (shard, local_row) layout and stack to (n_ps,
    max_rows, ...), the padding rows zero and never gathered (lookups use
    PS-linearized ids).  A new model: the other parameters are copies."""
    lin = torch.as_tensor(np.asarray(part.to_linear(np.arange(part.vocab))),
                          device=model.embed.device)
    stacked = {}
    for name in ("embed", "wide"):
        tbl = getattr(model, name)
        if tbl is None:
            continue
        full = torch.zeros((part.linear_size, tbl.shape[1]), dtype=tbl.dtype,
                           device=tbl.device)
        full[lin] = tbl.detach()
        stacked[name] = full.reshape(part.n_ps, part.max_rows, tbl.shape[1])
    def copy(ws):
        return [w.detach().clone() for w in ws]

    extra = {k: getattr(model, k).detach().clone()
             for k in ("cross_w", "cross_b") if getattr(model, k) is not None}
    out = DLRM(model.cfg, stacked["embed"], copy(model.bottom),
               copy(model.top), wide=stacked.get("wide"), **extra)
    return out.requires_grad_(model.embed.requires_grad)


def params_from_jax(np_params: dict, cfg: DLRMConfig, device="cpu") -> DLRM:
    """A model that computes what the JAX package's ``forward`` computes
    with ``np_params``: its ``init_params`` pytree with every leaf turned
    into a numpy array (``{"embed", "bottom": [{"w"}], "top": [{"w"}],
    "wide" | "cross_w", "cross_b"}``)."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    extra = {k: t(np_params[k]) for k in ("wide", "cross_w", "cross_b")
             if k in np_params}
    return DLRM(cfg, t(np_params["embed"]),
                [t(lp["w"]) for lp in np_params["bottom"]],
                [t(lp["w"]) for lp in np_params["top"]], **extra)


def ref_paths(model: DLRM) -> list:
    """Each of ``model.parameters()``'s place in the JAX package's tree
    (:mod:`repro_torch.models.tree`): ``embed``, ``bottom/i/w``,
    ``top/i/w``, ``wide`` or ``cross_w`` and ``cross_b``."""
    paths = []
    for name, _ in model.named_parameters():
        head, _, idx = name.partition(".")
        paths.append(((head, int(idx), "w") if idx else (head,), None))
    return paths


def params_to_jax(model: DLRM) -> dict:
    """:func:`params_from_jax`'s inverse: the JAX package's
    ``init_params`` pytree of ``model``'s weights, as numpy."""
    return to_numpy(to_ref(list(model.parameters()), ref_paths(model)))


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(model: DLRM, sparse_ids: torch.Tensor, dense: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of the model's logits (stable form)."""
    return torch.mean(_bce(model(sparse_ids, dense), labels))


def bce_loss_masked(model: DLRM, sparse_ids: torch.Tensor,
                    dense: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """PAD-masked BCE for uneven ragged batches (``cap_slack > 0``): rows
    with label -1 (the exchange's PAD fill) add neither loss nor
    gradient, and the mean runs over the valid rows only."""
    valid = labels >= 0.0
    logits = model(sparse_ids, dense)
    lbl = torch.where(valid, labels, torch.zeros_like(labels))
    per_row = torch.where(valid, _bce(logits, lbl),
                          torch.zeros_like(logits))
    return per_row.sum() / valid.sum().clamp(min=1).to(per_row.dtype)


def train_step(model: DLRM, cfg: DLRMConfig, batch: dict, lr: float = 1e-2):
    """Plain-SGD step (the paper's consistency analysis assumes SGD): the
    BCE loss of ``batch`` (``{sparse, dense, labels}`` tensors) and every
    parameter moved by ``-lr`` times its gradient.  Returns ``(the
    stepped model, the loss)``: a new model, ``model`` untouched, as the
    reference returns new parameters.  ``cfg`` is ``model.cfg`` (the
    reference's argument)."""
    new = copy.deepcopy(model).requires_grad_(True)
    params = list(new.parameters())
    with torch.enable_grad():
        loss = bce_loss(new, batch["sparse"], batch["dense"], batch["labels"])
        grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return new.requires_grad_(model.embed.requires_grad), loss.detach()
