"""Read-only per-worker cache planes with TTL-based refresh.

Serving reuses :class:`repro_torch.pipeline.prefetch.PrefetchPlane` with
``expiry`` read as a freshness deadline ``refreshed_at + ttl``: a row
answers lookups from its staged copy until the TTL lapses, then a
refresh re-pulls the current table value.  The step clock is the
micro-batch sequence number.

An exact (fp32) pull goes through :func:`repro_torch.kernels.
emb_lookup.staged_gather`, which writes a new plane: each refresh
rewrites all C rows, not only the due ones, as the JAX package's
out-of-place pull does.  With a wire ``codec`` the pull follows the
reference's quantized path instead: a plain gather of the rows, then
:func:`repro_torch.quant.codecs.fake_quant` (the rows as the quantized
wire delivers them), then a select over the plane.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.emb_lookup import staged_gather
from ..pipeline.prefetch import PrefetchPlane, prefetch_init
from ..quant.codecs import fake_quant, get_codec

__all__ = ["seed_plane", "refresh_plane", "plane_ages"]

_INT32_MAX = torch.iinfo(torch.int32).max


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
    plane = PrefetchPlane(
        ids=torch.as_tensor(ids, device=table.device),
        rows=plane.rows,
        expiry=torch.full((ids.size,), int(step) + int(ttl),
                          dtype=torch.int32, device=table.device),
    )
    # pull every row through the refresh path (same codec treatment)
    which = torch.ones((ids.size,), dtype=torch.bool, device=table.device)
    return _pull_rows(plane, table, which, codec=codec)


def _pull_rows(plane: PrefetchPlane, table: torch.Tensor,
               which: torch.Tensor, *, codec=None) -> PrefetchPlane:
    """Re-pull ``which`` slots' rows from ``table`` (in the wire format
    of ``codec``), carrying every other slot through."""
    V = table.shape[0]
    src = torch.where(which & (plane.ids >= 0), plane.ids.clamp(0, V - 1),
                      -1)
    c = get_codec(codec)
    if c is None:
        rows = staged_gather(plane.rows, table, src)
    else:
        pulled = fake_quant(table[src.clamp(0, V - 1)], c)
        rows = torch.where((src >= 0)[:, None], pulled, plane.rows)
    return PrefetchPlane(ids=plane.ids, rows=rows, expiry=plane.expiry)


def refresh_plane(plane: PrefetchPlane, table: torch.Tensor, step: int, *,
                  ttl: int, budget: int | None = None, codec=None):
    """One TTL round: re-pull up to ``budget`` expired rows.

    A slot is due when ``expiry <= step``.  Refreshed slots get
    ``expiry = step + ttl``; with a ``budget`` the stalest slots (lowest
    expiry, ties by slot) go first and the rest keep serving their old
    rows until a later round.  Returns ``(new_plane, n_refreshed)``, the
    count a 0-dim int tensor on the plane's device.
    """
    C = plane.ids.shape[0]
    due = (plane.ids >= 0) & (plane.expiry <= step)
    if budget is not None:
        order = torch.argsort(torch.where(due, plane.expiry, _INT32_MAX),
                              stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(C, device=order.device)
        due = due & (rank < budget)
    plane = _pull_rows(plane, table, due, codec=codec)
    new_exp = torch.where(due, int(step) + int(ttl), plane.expiry)
    return (PrefetchPlane(ids=plane.ids, rows=plane.rows, expiry=new_exp),
            due.sum())


def plane_ages(plane: PrefetchPlane, step: int, *, ttl: int) -> np.ndarray:
    """(C,) staleness age in steps of every occupied slot (host side):
    ``step - refreshed_at`` with ``refreshed_at = expiry - ttl``.  Empty
    slots report -1."""
    ids = plane.ids.cpu().numpy()
    exp = plane.expiry.cpu().numpy()
    age = int(step) - (exp - int(ttl))
    return np.where(ids >= 0, age, -1)
