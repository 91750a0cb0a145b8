"""Deep & Cross (arXiv:1708.05123) over one flat embedding table, as the
ESD paper trains it: x0 is the fields' rows (one id a field), the
history bag's mean row and the bottom MLP's projection of the dense
features, concatenated; each cross layer is x <- x0 * (x . w_l) + b_l +
x; the top MLP maps the last x to the logit.  No MLP biases."""
from __future__ import annotations

import torch

from ._mlp import mlp, mlp_flops, mlp_specs


def _x0_width(cfg: dict) -> int:
    return cfg["embedding_dim"] * (len(cfg["table_sizes"]) + 2)


def leaf_specs(cfg: dict) -> list:
    V, E = sum(cfg["table_sizes"]), cfg["embedding_dim"]
    dims, d = list(cfg["mlp_dims"]), _x0_width(cfg)
    return ([("embed", (V, E), 0.01)]
            + mlp_specs("bottom", cfg["n_dense"], dims + [E])
            + mlp_specs("top", d, dims + [1])
            + [("cross_w", (cfg["cross_layers"], d), d ** -0.5),
               ("cross_b", (cfg["cross_layers"], d), 0.0)])


def flops_per_sample(cfg: dict) -> int:
    """The MLPs' products; a cross layer's x @ w (2d), x0 * xw, + b, + x
    (3d); pooling the history bag."""
    E, d = cfg["embedding_dim"], _x0_width(cfg)
    dims = list(cfg["mlp_dims"])
    return (mlp_flops(cfg["n_dense"], dims + [E]) + mlp_flops(d, dims + [1])
            + cfg["cross_layers"] * 5 * d + cfg["hist_max"] * E)


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
