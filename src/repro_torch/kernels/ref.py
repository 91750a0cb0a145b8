"""Plain PyTorch oracles for the TPU kernels, with the JAX package's
``kernels/ref.py`` signatures (the allclose targets of its tests).

``pooled_lookup_ref`` is the pooled lookup's plain version
(:mod:`.emb_lookup`); ``auction_bids_ref`` is the bid kernel's
(:mod:`.auction`) with the reference's int32 ``best_j``;
``flash_attention_ref`` is the reference's naive softmax oracle (causal
and a sliding ``window``, f32 out), which B8's plain version (an online
softmax returning ``lse`` too, causal or not) is not.
"""
from __future__ import annotations

import torch

from .auction import auction_bids_ref as _bids
from .emb_lookup import pooled_lookup_ref

__all__ = ["pooled_lookup_ref", "auction_bids_ref", "flash_attention_ref"]


def auction_bids_ref(cost: torch.Tensor, min_price: torch.Tensor,
                     unassigned: torch.Tensor, eps):
    """Row-parallel bid phase of an auction round.  cost: (k, n);
    min_price: (n,); unassigned: (k,) bool.  Returns best_j (k,) int32
    and bid (k,) f32 (-1e30 for assigned rows)."""
    best_j, bid = _bids(cost, min_price, unassigned, eps)
    return best_j.to(torch.int32), bid.to(torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0):
    """Naive softmax attention in f32.  q: (B, Sq, KV, G, hd), k/v: (B, Sk,
    KV, hd) -> (B, Sq, KV, G, hd) f32; ``causal`` keeps keys at t <= s,
    ``window`` (> 0) those with s - t < window."""
    hd = q.shape[-1]
    logits = torch.einsum("bskgh,btkh->bkgst", q.float(),
                          k.float()) / hd ** 0.5
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    p = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v.float())
