"""Wide & Deep (arXiv:1606.07792) over one flat embedding table, as the
ESD paper trains it: the deep part's input is the mean of a sample's
embedding rows (its fields and its history bag, PAD -1 left out) plus
the bottom MLP's projection of the dense features; the wide part sums a
scalar row of each id.  No biases."""
from __future__ import annotations

import torch

from ._mlp import mlp


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
