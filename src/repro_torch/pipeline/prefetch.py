"""The fixed-capacity staging plane and its projection onto the id space.

The serving path (:mod:`repro_torch.serve.plane`) keeps one plane per
worker.  The training prefetch round that also fills planes comes with
the pipeline slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PrefetchPlane", "prefetch_init", "slot_map"]


@dataclasses.dataclass
class PrefetchPlane:
    """Fixed-capacity staging plane: slot s holds row ``rows[s]`` of id
    ``ids[s]`` (PAD = -1), live while the current step is at most
    ``expiry[s]``."""

    ids: torch.Tensor      # (C,) int32, -1 = empty slot
    rows: torch.Tensor     # (C, E) f32 staged table rows
    expiry: torch.Tensor   # (C,) int32 absolute step, -1 = empty


def prefetch_init(slots: int, emb_dim: int, device="cpu") -> PrefetchPlane:
    """An empty plane with ``slots`` staging rows of width ``emb_dim``."""
    return PrefetchPlane(
        ids=torch.full((slots,), -1, dtype=torch.int32, device=device),
        rows=torch.zeros((slots, emb_dim), dtype=torch.float32,
                         device=device),
        expiry=torch.full((slots,), -1, dtype=torch.int32, device=device),
    )


def slot_map(plane: PrefetchPlane, V: int, step: int) -> torch.Tensor:
    """(V,) int32: the staging slot holding id x's live row at ``step``,
    -1 where no live slot exists.  A slot is live while ``expiry >= step``
    (inclusive).  If an id ever occupied two live slots the highest slot
    wins."""
    alive = (plane.ids >= 0) & (plane.expiry >= step)
    idx = torch.where(alive, plane.ids, V).long()
    C = plane.ids.shape[0]
    out = torch.full((V + 1,), -1, dtype=torch.int32, device=plane.ids.device)
    out.scatter_reduce_(0, idx, torch.arange(C, dtype=torch.int32,
                                             device=out.device), "amax")
    return out[:V]
