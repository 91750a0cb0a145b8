"""Wide & Deep (arXiv:1606.07792) over one flat embedding table, as the
ESD paper trains it: the deep part's input is the mean of a sample's
embedding rows (its fields' bags and its history bag, PAD -1 left out)
plus the bottom MLP's projection of the dense features; the wide part
sums a scalar row of each id.  No biases."""
from __future__ import annotations

import torch

from ...gen import record_width
from ._mlp import mlp, mlp_flops, mlp_specs


def leaf_specs(cfg: dict) -> list:
    V, E = sum(cfg["table_sizes"]), cfg["embedding_dim"]
    dims = list(cfg["mlp_dims"])
    return ([("embed", (V, E), 0.01)]
            + mlp_specs("bottom", cfg["n_dense"], dims + [E])
            + mlp_specs("top", E, dims + [1])
            + [("wide", (V, 1), 0.01)])


def flops_per_sample(cfg: dict) -> int:
    """The MLPs' products; the mean over the record's W rows, the dense
    projection added, the wide part's W scalars."""
    E, W = cfg["embedding_dim"], record_width(cfg)
    dims = list(cfg["mlp_dims"])
    return (mlp_flops(cfg["n_dense"], dims + [E])
            + mlp_flops(E, dims + [1]) + W * E + E + W)


def forward(P: dict, ids: torch.Tensor, dense: torch.Tensor, cfg: dict,
            mm) -> torch.Tensor:
    valid = ids >= 0
    g = torch.where(valid, ids, 0).long()
    rows = P["embed"][g] * valid[..., None].to(P["embed"].dtype)
    n_valid = valid.sum(dim=1, keepdim=True).clamp(min=1)
    d = mlp(P, "bottom", dense.to(rows.dtype), len(cfg["mlp_dims"]) + 1, mm)
    deep = mlp(P, "top", rows.sum(dim=1) / n_valid + d,
               len(cfg["mlp_dims"]) + 1, mm)[:, 0]
    wide = (P["wide"][g][..., 0] * valid.to(rows.dtype)).sum(dim=1)
    return deep + wide
