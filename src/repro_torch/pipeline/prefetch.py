"""Window-driven prefetch: stage future-miss rows while training runs.

The counterpart of the JAX package's ``pipeline/prefetch.py``.  The
lookahead window (:mod:`repro_torch.pipeline.window`) names every id the
next W batches will touch and when.  While step t trains, the rows the
window says steps t+1..t+W will miss are moved from the PS tier into a
fixed-size *staging plane*, so that when the miss happens the row is
already local: the miss is still counted, but its transfer was hidden
under an earlier train step.  The cache-state update reports the split
as ``prefetch_hit`` (a miss whose row was staged) and ``demand_miss``.

Per step:

  1. :func:`prefetch_candidates` (host, numpy, the reference's line for
     line) ranks the window's ids by first use and stamps each with the
     absolute step of its last use inside the window;
  2. :func:`prefetch_step` refreshes the expiry of staged ids, drops
     candidates that are resident in a worker cache or already staged,
     and stages up to ``budget`` new rows into dead slots.  It is two
     halves, which a pipelined driver issues on different CUDA streams:
     :func:`prefetch_select` reads only the plane's ids and expiry and
     the cache state, and :func:`prefetch_pull` reads the table.  The
     exact pull is one launch of :func:`repro_torch.kernels.emb_lookup.
     staged_gather` (kernel B3), which writes the chosen table rows into
     a new plane and carries every other slot through; with a ``codec``
     the pulled rows go through :func:`fake_quant` first, so the plane
     holds what the quantized wire would deliver;
  3. :func:`staged_membership` projects the plane onto a (V,) bool mask,
     the ``staged=`` argument of the cache-state update.

The plane moves bytes and accounting, never values: training reads the
canonical table, so the losses do not change with prefetch on.

The serving path (:mod:`repro_torch.serve.plane`) keeps one plane per
worker and reads it through :func:`slot_map`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.emb_lookup import staged_gather
from ..quant.codecs import fake_quant, get_codec

__all__ = ["PrefetchPlane", "prefetch_init", "prefetch_candidates",
           "PrefetchSelection", "prefetch_select", "prefetch_pull",
           "prefetch_step", "staged_membership", "slot_map"]


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


def prefetch_candidates(meta, step: int, max_cands: int,
                        part=None) -> tuple[np.ndarray, np.ndarray]:
    """Rank the window's ids into a fixed-size candidate list (host side).

    ``meta`` is the :class:`~repro_torch.pipeline.window.WindowMeta`
    delivered with step ``step``'s batch, covering batches ``step+1 ..
    step+W``: an id whose ``first_use`` is f is next needed at absolute
    step ``step + 1 + f``.  Candidates are ordered by first use (a budget
    cut drops the farthest-future rows) and stamped with ``expiry = step
    + 1 + last_use``.  Returns ``(ids, expiry)`` int32 arrays of length
    ``max_cands``, PAD = -1.  With ``part`` the ids are emitted in the
    PS-linearized space.
    """
    ids = np.asarray(meta.uids, np.int64)
    if part is not None and ids.size:
        ids = np.asarray(part.to_linear(ids), np.int64)
    order = np.argsort(meta.first_use, kind="stable")
    ids = ids[order][:max_cands]
    expiry = (int(step) + 1 + np.asarray(meta.last_use,
                                         np.int64)[order][:max_cands])
    out_ids = np.full(max_cands, -1, np.int32)
    out_exp = np.full(max_cands, -1, np.int32)
    out_ids[:len(ids)] = ids
    out_exp[:len(ids)] = expiry
    return out_ids, out_exp


@dataclasses.dataclass
class PrefetchSelection:
    """What one prefetch round decided, before any row moves: the plane's
    new ``ids`` and ``expiry``; ``src`` (C,), the table row each slot
    pulls or -1 (the exact pull's input); ``sel_ids``, ``sel_slot`` and
    ``sel_ok`` (budget,), the pulled ids, their slots (C = none) and
    which ranks pulled (the codec pull's inputs); ``n_pulled``, 0-dim
    int32."""

    ids: torch.Tensor
    expiry: torch.Tensor
    src: torch.Tensor
    sel_ids: torch.Tensor
    sel_slot: torch.Tensor
    sel_ok: torch.Tensor
    n_pulled: torch.Tensor


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(vals, mode="drop")`` along dim 0 for idx in
    [0, len(base)]: index len(base) lands in a scratch row that is cut
    off."""
    ext = torch.cat([base, base[:1]], dim=0)
    return ext.index_copy_(0, idx.long(), vals)[:base.shape[0]]


def prefetch_select(plane: PrefetchPlane, resident: torch.Tensor,
                    cand_ids: torch.Tensor, cand_expiry: torch.Tensor,
                    step: int, *, budget: int) -> PrefetchSelection:
    """The selection half of :func:`prefetch_step`: reads the plane's ids
    and expiry, never its rows or the table.

    Policy, in order: (a) ids already staged only refresh their expiry
    to the newest last use; (b) resident ids are skipped; (c) the first
    ``min(budget, free slots)`` remaining candidates (they arrive
    urgency-sorted) take the dead slots in slot order."""
    C = plane.ids.shape[0]
    P = cand_ids.shape[0]
    V = resident.shape[0]
    dev = plane.ids.device

    alive = (plane.ids >= 0) & (plane.expiry >= step)
    cvalid = cand_ids >= 0
    eq = ((plane.ids[:, None] == cand_ids[None, :])
          & alive[:, None] & cvalid[None, :])                     # (C, P)
    best = torch.where(eq, cand_expiry[None, :], -1).amax(dim=1)
    expiry0 = torch.where(alive, torch.maximum(plane.expiry, best), -1)
    ids0 = torch.where(alive, plane.ids, -1)

    staged_already = eq.any(dim=0)                                # (P,)
    res = resident[cand_ids.clamp(0, V - 1).long()] & cvalid
    want = cvalid & ~staged_already & ~res
    n_free = C - alive.sum()
    rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    take = want & (rank < n_free.clamp(max=budget))

    # sel_cand[r] = the candidate taken at rank r, -1 past the last
    scatter_to = torch.where(take, rank, budget)
    sel_cand = _scatter_drop(
        torch.full((budget,), -1, dtype=torch.int32, device=dev),
        scatter_to, torch.arange(P, dtype=torch.int32, device=dev))
    sel_ok = sel_cand >= 0
    sel_cand_c = sel_cand.clamp(0, P - 1).long()
    sel_ids = torch.where(sel_ok, cand_ids[sel_cand_c], -1)
    sel_exp = torch.where(sel_ok, cand_expiry[sel_cand_c], -1)
    # rank r lands in the r-th dead slot (a stable sort puts dead first)
    dead_first = torch.argsort(alive.to(torch.int32),
                               stable=True).to(torch.int32)
    if budget > C:
        dead_first = torch.cat([dead_first, torch.full(
            (budget - C,), C, dtype=torch.int32, device=dev)])
    sel_slot = torch.where(sel_ok, dead_first[:budget], C)        # C: drop

    return PrefetchSelection(
        ids=_scatter_drop(ids0, sel_slot, sel_ids),
        expiry=_scatter_drop(expiry0, sel_slot, sel_exp),
        src=_scatter_drop(torch.full((C,), -1, dtype=torch.int32,
                                     device=dev),
                          sel_slot, sel_ids.clamp(0, V - 1)),
        sel_ids=sel_ids, sel_slot=sel_slot, sel_ok=sel_ok,
        n_pulled=take.sum(dtype=torch.int32))


def prefetch_pull(rows: torch.Tensor, table: torch.Tensor,
                  sel: PrefetchSelection, codec=None) -> torch.Tensor:
    """The pull half of :func:`prefetch_step`: the plane's new (C, E)
    rows, the selected table rows written into their slots.  Exact: one
    :func:`staged_gather` launch.  With a ``codec``: the reference's
    path, a gather, :func:`fake_quant`, and a scatter into the slots."""
    c = get_codec(codec)
    if c is None:
        return staged_gather(rows, table, sel.src)
    V = table.shape[0]
    pulled = fake_quant(table[sel.sel_ids.clamp(0, V - 1).long()], c)
    return _scatter_drop(rows, sel.sel_slot,
                         torch.where(sel.sel_ok[:, None], pulled, 0.0))


def prefetch_step(plane: PrefetchPlane, table: torch.Tensor,
                  resident: torch.Tensor, cand_ids: torch.Tensor,
                  cand_expiry: torch.Tensor, step: int, *, budget: int,
                  codec=None) -> tuple[PrefetchPlane, torch.Tensor]:
    """One prefetch round: stage up to ``budget`` future-miss rows.

    plane: the current staging plane; table: (V, E) canonical rows (the
    PS tier); resident: (V,) bool cluster residency (a row some worker
    caches is never a future miss); cand_ids / cand_expiry: (P,) int32
    from :func:`prefetch_candidates`; step: the current absolute step
    (the expiry clock).  Returns ``(new_plane, n_pulled)``, ``n_pulled``
    a 0-dim int32 tensor."""
    sel = prefetch_select(plane, resident, cand_ids, cand_expiry, step,
                          budget=budget)
    rows = prefetch_pull(plane.rows, table, sel, codec)
    return (PrefetchPlane(ids=sel.ids, rows=rows, expiry=sel.expiry),
            sel.n_pulled)


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


def staged_membership(plane: PrefetchPlane, V: int, step: int
                      ) -> torch.Tensor:
    """(V,) bool: ids with a live staged row at ``step`` (the ``staged=``
    miss split of :func:`repro_torch.core.dispatch.
    esd_state_update_sparse`)."""
    alive = (plane.ids >= 0) & (plane.expiry >= step)
    idx = torch.where(alive, plane.ids, V).long()
    out = torch.zeros((V + 1,), dtype=torch.bool, device=plane.ids.device)
    return out.index_fill_(0, idx, True)[:V]
