"""The serve step: staged-plane lookup + dense forward only.

The embedding half answers from the worker's read-only TTL cache plane
(only plane misses touch the canonical table) and the dense half is the
unchanged DLRM interaction stack — no optimizer state, no gradient, no
push.  Each call returns

* ``logits`` (B,) — the CTR answer, built on plane-served embedding rows
  injected into :meth:`repro_torch.models.dlrm.DLRM.forward`;
* ``pooled`` (B, E) — the mean of the multi-hot history bag, summed by
  :func:`repro_torch.kernels.emb_lookup.pooled_lookup_staged` (the CUDA
  kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import torch

from ..configs.dlrm_configs import DLRMConfig
from ..kernels.emb_lookup import pooled_lookup_staged
from ..models.dlrm import DLRM
from ..pipeline.prefetch import PrefetchPlane, slot_map

__all__ = ["staged_emb_all", "make_serve_step"]


def staged_emb_all(plane: PrefetchPlane, table: torch.Tensor,
                   sparse_ids: torch.Tensor, step: int):
    """(B, W, E) embedding rows with the plane override: slot-served
    where a live staged copy exists, canonical table elsewhere, zero on
    PAD.  Also returns the (B, W) int32 slot indices (-1 = table)."""
    V = table.shape[0]
    C = plane.ids.shape[0]
    valid = sparse_ids >= 0
    ids = torch.where(valid, sparse_ids, 0).long()
    smap = slot_map(plane, V, step)                      # (V,) int32
    slots = torch.where(valid, smap[ids], -1)            # (B, W)
    from_plane = plane.rows[slots.long().clamp(0, max(C - 1, 0))]
    rows = torch.where((slots >= 0)[..., None], from_plane, table[ids])
    return rows * valid[..., None], slots


def make_serve_step(cfg: DLRMConfig, n_fields: int):
    """Build ``serve_step(model, plane, sparse, dense, step) -> (logits,
    pooled)`` for one DLRM config.

    ``sparse`` (B, W) ids and ``dense`` (B, n_dense) may be numpy arrays
    or tensors; they move to the model's device.  ``step`` is the plane's
    freshness clock (micro-batch sequence number).
    """
    F = n_fields

    @torch.no_grad()
    def serve_step(model: DLRM, plane: PrefetchPlane, sparse, dense,
                   step: int):
        table = model.embed
        dev = table.device
        sparse = torch.as_tensor(sparse, device=dev)
        dense = torch.as_tensor(dense, device=dev)
        emb_all, slots = staged_emb_all(plane, table, sparse, step)
        logits = model(sparse, dense, n_fields=F, emb_all=emb_all)
        hist_ids = sparse[:, F:].to(torch.int32).contiguous()
        pooled = pooled_lookup_staged(plane.rows, table,
                                      slots[:, F:].contiguous(), hist_ids)
        hn = (hist_ids >= 0).sum(dim=1, keepdim=True).clamp(min=1)
        return logits, pooled / hn

    return serve_step
