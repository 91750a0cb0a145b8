"""Read-only per-worker cache planes with TTL-based refresh.

Serving reuses :class:`repro_torch.pipeline.prefetch.PrefetchPlane` with
``expiry`` read as a freshness deadline ``refreshed_at + ttl``: a row
answers lookups from its staged copy until the TTL lapses, then a
refresh re-pulls the current table value.  The step clock is the
micro-batch sequence number.

A refresh runs in place on the plane it is given: one launch of
:func:`repro_torch.kernels.emb_lookup.plane_refresh` (two without a
budget, as when seeding: the list is then pulled over the grid) finds
the due slots, keeps the budget's stalest (a stable select by expiry,
ties by slot: the reference's argsort ranks), pulls their rows, stamps
their expiry and counts them on the device.  No other row is read or written,
where the JAX package's out-of-place pull rewrites all C rows.  With a
wire ``codec`` the kernel only selects and stamps: the kept rows (at
most the budget) are gathered, go through
:func:`repro_torch.quant.codecs.fake_quant` (the rows as the quantized
wire delivers them; its groups lie within a row, so a row's value does
not depend on the others) and :func:`repro_torch.kernels.emb_lookup.
staged_pull` writes them into their slots.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.emb_lookup import plane_refresh, staged_pull
from ..pipeline.prefetch import PrefetchPlane, prefetch_init
from ..quant.codecs import fake_quant, get_codec

__all__ = ["seed_plane", "refresh_plane", "plane_ages"]


def seed_plane(table: torch.Tensor, ids: np.ndarray, *, step: int,
               ttl: int, codec=None) -> PrefetchPlane:
    """A fresh serve plane on ``table``'s device holding ``ids``'s rows,
    all stamped ``expiry = step + ttl``.  ``ids`` (C,) must be unique.
    With a ``codec`` the seeded rows already carry the wire format, like
    every later refresh."""
    ids = np.asarray(ids, np.int32)
    if ids.size and len(np.unique(ids)) != ids.size:
        raise ValueError("seed_plane ids must be unique")
    plane = prefetch_init(int(ids.size), int(table.shape[1]), table.device)
    # every occupied slot is due at ``step``: the refresh without a budget
    # pulls them all (same codec treatment) and stamps step + ttl
    expiry = np.where(ids >= 0, int(step), int(step) + int(ttl))
    plane = PrefetchPlane(
        ids=torch.as_tensor(ids, device=table.device),
        rows=plane.rows,
        expiry=torch.as_tensor(expiry.astype(np.int32), device=table.device),
    )
    return refresh_plane(plane, table, step, ttl=ttl, codec=codec)[0]


def refresh_plane(plane: PrefetchPlane, table: torch.Tensor, step: int, *,
                  ttl: int, budget: int | None = None, codec=None):
    """One TTL round: re-pull up to ``budget`` expired rows, in place.

    A slot is due when ``expiry <= step``.  Refreshed slots get
    ``expiry = step + ttl``; with a ``budget`` the stalest slots (lowest
    expiry, ties by slot) go first and the rest keep serving their old
    rows until a later round.  Returns ``(plane, n_refreshed)``: the same
    plane, its ``rows`` and ``expiry`` updated in place, and the count, a
    0-dim int32 tensor on the plane's device (reading it waits for the
    device).
    """
    c = get_codec(codec)
    if c is None:
        n, _, _ = plane_refresh(plane, table, step, ttl, budget)
        return plane, n
    n, slot, sel_ids = plane_refresh(plane, table, step, ttl, budget,
                                     pull=False)
    V = table.shape[0]
    pulled = fake_quant(table[sel_ids.clamp(0, V - 1).long()], c)
    staged_pull(plane.rows, pulled, slot)
    return plane, n


def plane_ages(plane: PrefetchPlane, step: int, *, ttl: int) -> np.ndarray:
    """(C,) staleness age in steps of every occupied slot (host side):
    ``step - refreshed_at`` with ``refreshed_at = expiry - ttl``.  Empty
    slots report -1."""
    ids = plane.ids.cpu().numpy()
    exp = plane.expiry.cpu().numpy()
    age = int(step) - (exp - int(ttl))
    return np.where(ids >= 0, age, -1)
