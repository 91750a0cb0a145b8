"""Deep & Cross (arXiv:1708.05123) over one flat embedding table, as the
ESD paper trains it: x0 is the fields' rows, the history bag's mean row
and the bottom MLP's projection of the dense features, concatenated;
each cross layer is x <- x0 * (x . w_l) + b_l + x; the top MLP maps the
last x to the logit.  No MLP biases."""
from __future__ import annotations

import torch

from ._mlp import mlp


def forward(P: dict, ids: torch.Tensor, dense: torch.Tensor, cfg: dict,
            mm) -> torch.Tensor:
    F = len(cfg["table_sizes"])
    valid = ids >= 0
    g = torch.where(valid, ids, 0).long()
    rows = P["embed"][g] * valid[..., None].to(P["embed"].dtype)
    n_hist = valid[:, F:].sum(dim=1, keepdim=True).clamp(min=1)
    pooled = rows[:, F:].sum(dim=1) / n_hist
    d = mlp(P, "bottom", dense.to(rows.dtype), len(cfg["mlp_dims"]) + 1, mm)
    B = ids.shape[0]
    x0 = torch.cat([rows[:, :F].reshape(B, -1), pooled, d], dim=1)
    x = x0
    for layer in range(cfg["cross_layers"]):
        xw = mm(x, P["cross_w"][layer][:, None])[:, 0]
        x = x0 * xw[:, None] + P["cross_b"][layer][None, :] + x
    return mlp(P, "top", x, len(cfg["mlp_dims"]) + 1, mm)[:, 0]
