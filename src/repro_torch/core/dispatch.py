"""ESD on the device: Alg. 1 cost, Alg. 2 dispatch and the sparse cache
state machine of the training step, in PyTorch.

The counterpart of the JAX package's ``core/dispatch_tpu.py`` (named for
what it does here, not for the TPU).  The reference runs one shard per
device under ``shard_map``; the port runs the ``n`` workers of a step on
one device with the worker as a leading tensor dimension, and each
worker's decision stays independent of the others', as under
``shard_map``.  Ported for the training step:

  * Alg. 1 (:func:`esd_cost_matrix`): always the touched-ids pooled
    lookup (:func:`repro_torch.kernels.ops.cost_matrix_sparse_kernel`),
    so card and CPU sum in one order;
  * Alg. 2 (:func:`hybrid_dispatch`): the top ``floor(k * alpha)``
    regret rows go to the eps-scaled auction (:func:`auction_fixed`:
    every worker's auction in one launch of the fused auction kernel,
    a block each), the rest to the greedy
    :func:`heu_dispatch`.  The greedy scans and the auction's straggler
    placement are sequential over samples; they run on the host over
    small integer arrays, in the reference's order;
  * the pipelined step's repair of a stale assignment
    (:func:`changed_samples_mask`, :func:`esd_reassign`, the same
    host-side capped scan);
  * the sparse cache state (:class:`SparseEsdState`,
    :func:`esd_state_update_sparse`) and :func:`need_ids_list`.

Every argsort is stable, as the reference's.  A ``mode="drop"`` scatter
of the reference lands in a scratch slot past the end here and is cut
off.  Ids stay int32 in state and outputs; indexing uses int64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import auction as KA
from ..kernels.ops import cost_matrix_sparse_kernel
from .cost import unique_padded

__all__ = ["heu_dispatch", "changed_samples_mask", "esd_reassign",
           "auction_fixed", "hybrid_dispatch", "dispatch_cap",
           "exchange_budget", "esd_cost_matrix", "esd_decide",
           "SparseEsdState", "esd_sparse_init", "esd_state_update_sparse",
           "need_ids_list"]

_I32_MAX = int(np.iinfo(np.int32).max)


# --------------------------------------------------------------------------
# dispatch decision methods
# --------------------------------------------------------------------------
def _regret(C: torch.Tensor) -> torch.Tensor:
    """Second-smallest minus smallest cost of each row (last dim)."""
    if C.shape[-1] == 1:
        return torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    top2 = -torch.topk(-C, 2, dim=-1).values         # two smallest
    return top2[..., 1] - top2[..., 0]


def _first_free(row, wl, cap: int) -> int:
    """The first worker in preference order ``row`` with spare capacity,
    else ``row[0]`` (``jnp.argmax`` of an all-false mask is 0)."""
    for j in row:
        if wl[j] < cap:
            return j
    return row[0]


def heu_dispatch(C: torch.Tensor, cap: int, workload=None) -> torch.Tensor:
    """Greedy Heu (Alg. 2 L9-18): rows in regret-descending order each
    take their cheapest worker with spare capacity, starting from
    ``workload`` (n,) rows already placed.  C: (k, n) -> (k,) int32.  The
    scan is sequential, so it runs on the host over the preference
    table, in the reference's order."""
    k, n = C.shape
    order = torch.argsort(-_regret(C), stable=True)
    pref = torch.argsort(C, dim=1, stable=True).tolist()
    wl = ([0] * n if workload is None
          else [int(v) for v in torch.as_tensor(workload).tolist()])
    out = [0] * k
    for i in order.tolist():
        j = _first_free(pref[i], wl, cap)
        wl[j] += 1
        out[i] = j
    return torch.tensor(out, dtype=torch.int32, device=C.device)


def changed_samples_mask(samples: torch.Tensor, state_a, state_b
                         ) -> torch.Tensor:
    """(..., m) bool: samples (..., m, F) holding at least one id whose
    Alg.-1 state column (``latest`` or ``dirty``) differs between two
    SparseEsdStates — exactly the rows whose stale cost can differ from
    the committed one, the only rows :func:`esd_reassign` re-places.
    PAD (-1) ids never flag a sample."""
    V = state_a.latest.shape[1]
    valid = samples >= 0
    g = samples.clamp(0, V - 1).long()
    diff = ((state_a.latest[:, g] != state_b.latest[:, g])
            | (state_a.dirty[:, g] != state_b.dirty[:, g])).any(dim=0)
    return (diff & valid).any(dim=-1)


def esd_reassign(C: torch.Tensor, assign: torch.Tensor,
                 flagged: torch.Tensor, cap: int):
    """Repair a stale assignment against a fresh cost matrix.

    Every unflagged sample keeps its stale worker (its cost row is what
    the decide-time state gave, so the stale choice stands); the flagged
    rows, in regret-descending order, each take their cheapest worker
    with spare capacity, starting from the unflagged rows' workload — the
    reference's capped scan, run on the host over the preference table
    as :func:`heu_dispatch` runs.  C: (k, n), or (B, k, n) for B workers'
    independent repairs; assign, flagged: (k,) / (B, k).  Returns
    ``(assign, n_reassigned)``: int32 of assign's shape, and the flagged
    count, a 0-dim int32 tensor summed over the B repairs."""
    single = C.dim() == 2
    if single:
        C, assign, flagged = C[None], assign[None], flagged[None]
    B, k, n = C.shape
    # flagged rows first, by regret; the pass-through rows keep their
    # worker and never move the workload the scan fills
    key = -torch.where(flagged, _regret(C),
                       torch.full_like(C[..., 0], -float("inf")))
    order = torch.argsort(key, dim=1, stable=True).tolist()
    pref = torch.argsort(C, dim=2, stable=True).tolist()
    out = assign.to(torch.int32).tolist()
    flags = flagged.tolist()
    for b in range(B):
        wl = [0] * n
        for j, f in zip(out[b], flags[b]):
            if not f:
                wl[j] += 1
        for i in order[b]:
            if flags[b][i]:
                j = _first_free(pref[b][i], wl, cap)
                wl[j] += 1
                out[b][i] = j
    out = torch.tensor(out, dtype=torch.int32, device=C.device)
    n_re = flagged.sum(dtype=torch.int32)
    return (out[0] if single else out), n_re


def _eps(span: torch.Tensor, e_pow: int) -> torch.Tensor:
    """span / 2 / 6**e_pow as XLA evaluates the reference's f32 division
    by a power: a multiply by its f32 reciprocal."""
    inv = np.float32(1.0) / np.float32(6.0 ** e_pow)
    return (span / 2.0) * float(inv)


def auction_fixed(C: torch.Tensor, capacity: int, n_phases: int = 7,
                  rounds_per_phase: int = 2000) -> torch.Tensor:
    """eps-scaled auction with a fixed phase schedule (reference
    ``auction_fixed``).  C: (k, n), or (B, k, n) for B independent
    auctions -> (k,) / (B, k) int32, -1 where a row stayed unassigned.

    The eps table of the ``n_phases + 2`` phases (the two extra terminal
    phases rerun repair and re-bid at the final eps) is built here; the
    B auctions then run in one launch of the fused auction kernel, a
    block each, every phase's rounds tested for an unassigned row before
    each round on the device, at most ``rounds_per_phase`` a phase.
    """
    single = C.dim() == 2
    C = (C[None] if single else C).to(torch.float32).contiguous()
    span = (C.amax(dim=(1, 2)) - C.amin(dim=(1, 2))).clamp(min=1e-6)
    eps = torch.stack([_eps(span, min(p, n_phases - 1))
                       for p in range(n_phases + 2)], dim=1)
    assign = KA.auction_solve(C, capacity, eps, rounds_per_phase)[0]
    return assign[0] if single else assign


def hybrid_dispatch(C: torch.Tensor, m: int, alpha: float,
                    cap: Optional[int] = None) -> torch.Tensor:
    """Alg. 2: the top floor(k * alpha) regret rows go to the auction,
    the rest to the greedy.  Per-worker capacity defaults to the hard
    m/n split; ``cap > m/n`` lets the assignment skew.  C: (k, n), or
    (B, k, n) for B workers' independent decisions -> (k,) / (B, k)
    int32."""
    single = C.dim() == 2
    C = C[None] if single else C
    B, k, n = C.shape
    dev = C.device

    def out(a):
        return a[0] if single else a

    if n == 1:
        return out(torch.zeros((B, k), dtype=torch.int32, device=dev))
    if cap is None:
        cap = m // n if m >= n else 1
    if cap * n < k:
        raise ValueError(f"infeasible: cap {cap} * n {n} < k {k}")
    opt_cap = int(np.floor(cap * alpha)) if alpha < 1.0 else cap
    opt_rows = (min(int(np.floor(k * alpha)), opt_cap * n)
                if alpha > 0.0 else 0)
    if opt_rows == 0:
        return out(torch.stack([heu_dispatch(C[b], cap) for b in range(B)]))
    order = torch.argsort(-_regret(C), dim=1, stable=True)         # (B, k)
    opt_idx, heu_idx = order[:, :opt_rows], order[:, opt_rows:]
    C_opt = torch.gather(C, 1, opt_idx[:, :, None].expand(B, opt_rows, n))
    a_opt = auction_fixed(C_opt, opt_cap)
    placed = a_opt >= 0
    if not bool(placed.all()):
        # stragglers: each unplaced row, in order, takes its cheapest
        # worker with spare capacity (the reference's capacity-respecting
        # scan changes nothing at placed rows, so it runs over the rest)
        pref = torch.argsort(C_opt, dim=2, stable=True).tolist()
        a_host = a_opt.tolist()
        for b in range(B):
            wl = [0] * n
            for j in a_host[b]:
                if j >= 0:
                    wl[j] += 1
            for i, j in enumerate(a_host[b]):
                if j < 0:
                    j_new = _first_free(pref[b][i], wl, opt_cap)
                    wl[j_new] += 1
                    a_host[b][i] = j_new
        a_opt = torch.tensor(a_host, dtype=torch.int32, device=dev)
    assign = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    assign.scatter_(1, opt_idx, a_opt)
    if opt_rows < k:
        for b in range(B):
            workload = torch.bincount(a_opt[b].long(), minlength=n)
            a_heu = heu_dispatch(C[b][heu_idx[b]], cap, workload=workload)
            assign[b].scatter_(0, heu_idx[b], a_heu)
    return out(assign)


def dispatch_cap(m: int, n: int, cap_slack: float = 0.0) -> int:
    """Per-(shard, worker) dispatch capacity: the hard m/n split relaxed
    by ``cap_slack`` (fraction of m/n a worker may exceed it by)."""
    base = m // n if m >= n else 1
    if cap_slack <= 0.0:
        return base
    return min(m, int(np.ceil(base * (1.0 + cap_slack))))


def exchange_budget(cap: int, m: int) -> int:
    """Static per-link send-block rows for the ragged executor: the
    capacity bucketed up to a power of two (<= m)."""
    return min(m, 1 << max(cap - 1, 0).bit_length())


def esd_cost_matrix(samples: torch.Tensor, state, t_tran: torch.Tensor
                    ) -> torch.Tensor:
    """One worker's (m, n) Alg. 1 cost matrix under ``state`` (single PS,
    no column bias), through the pooled-lookup kernel."""
    return cost_matrix_sparse_kernel(samples, state.latest, state.dirty,
                                     t_tran)


def esd_decide(samples: torch.Tensor, state, t_tran: torch.Tensor,
               alpha: float, cap_slack: float = 0.0,
               with_cost: bool = False):
    """Alg. 1 + Alg. 2 for every worker: samples (n, m, F), one row
    block per worker -> assign (n, m) int32, and with ``with_cost`` also
    each worker's Alg.-1 objective of its assignment (n,) f32."""
    n, m, _ = samples.shape
    C = torch.stack([esd_cost_matrix(samples[i], state, t_tran)
                     for i in range(n)])                          # (n, m, n)
    assign = hybrid_dispatch(C, m, alpha, cap=dispatch_cap(m, n, cap_slack))
    if with_cost:
        alg1 = torch.gather(C, 2, assign.long()[:, :, None])[:, :, 0].sum(1)
        return assign, alg1
    return assign


# --------------------------------------------------------------------------
# sparse (touched-ids) cache state + accounting
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SparseEsdState:
    """Replicated cache state for the incremental engine: the (n, V)
    planes, only ever updated at touched ids, and the (n, S) ids that
    survived the last LRU cut (PAD = -1), the bounded candidate set the
    next cut ranks."""
    latest: torch.Tensor        # (n, V) bool
    dirty: torch.Tensor         # (n, V) bool
    last_access: torch.Tensor   # (n, V) int32
    slots: torch.Tensor         # (n, S) int32, PAD = -1
    step: torch.Tensor          # () int32


def esd_sparse_init(n_workers: int, vocab: int,
                    capacity: Optional[int] = None, max_ids: int = 0,
                    device="cpu") -> SparseEsdState:
    """``max_ids`` = L, the per-worker padded id-list width the state
    will be stepped with (the slot buffer holds S = capacity + L)."""
    if capacity is not None and np.ndim(capacity) > 0:
        raise NotImplementedError(
            "per-PS capacities come with multi-PS (ROADMAP A2)")
    S = 0 if capacity is None or capacity >= vocab else capacity + max_ids
    return SparseEsdState(
        torch.zeros((n_workers, vocab), dtype=torch.bool, device=device),
        torch.zeros((n_workers, vocab), dtype=torch.bool, device=device),
        torch.zeros((n_workers, vocab), dtype=torch.int32, device=device),
        torch.full((n_workers, S), -1, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def _set_cols(plane: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``plane.at[:, cols].set(vals, mode="drop")`` for cols in [0, V]."""
    V = plane.shape[1]
    ext = torch.cat([plane, plane[:, :1]], dim=1)
    return ext.index_copy_(1, cols.long(), vals)[:, :V]


def _clear_at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane.at[rows, idx].set(False, mode="drop")`` for idx in [0, V]."""
    n, V = plane.shape
    hit = torch.zeros((n, V + 1), dtype=torch.bool, device=plane.device)
    hit.scatter_(1, idx.long(), True)
    return plane & ~hit[:, :V]


def _lexsort2(a: torch.Tensor, b: torch.Tensor):
    """Sort rows by (a, b): ``lax.sort((a, b), num_keys=2)``."""
    ob = torch.argsort(b, dim=1, stable=True)
    a1, b1 = torch.gather(a, 1, ob), torch.gather(b, 1, ob)
    oa = torch.argsort(a1, dim=1, stable=True)
    return torch.gather(a1, 1, oa), torch.gather(b1, 1, oa)


def esd_state_update_sparse(state: SparseEsdState, need_ids: torch.Tensor,
                            capacity: Optional[int] = None, part=None,
                            staged=None):
    """One BSP iteration of the cache protocol, driven by touched ids
    (reference ``esd_state_update_sparse``, single PS).

    need_ids: (n, L) int32, the ids each worker trains this iteration,
    unique within each row, PAD = -1 (see :func:`need_ids_list`).
    Returns (new_state, counts) with per-worker ``miss_pull``,
    ``update_push`` and ``evict_push`` (n,) int32.  ``staged``, the
    (V,) bool membership of the prefetch plane
    (:func:`repro_torch.pipeline.prefetch.staged_membership`), splits
    the misses into ``prefetch_hit`` (the row was staged) and
    ``demand_miss``; the state is the same with or without it.
    """
    if part is not None:
        raise NotImplementedError("multi-PS state comes with ROADMAP A2")
    n, L = need_ids.shape
    V = state.latest.shape[1]
    dev = need_ids.device
    step = state.step + 1
    valid = need_ids >= 0

    # touched-id universe: sorted unique over all workers, pad sentinel V
    flat = torch.where(valid, need_ids, V).reshape(-1)
    uids = unique_padded(flat, V)                                 # (U,)
    U = uids.shape[0]
    uvalid = uids < V
    g = uids.clamp(max=V - 1).long()

    # need membership on the compact universe
    pos = torch.searchsorted(uids, torch.where(valid, need_ids, V))
    needU = torch.zeros((n, U + 1), dtype=torch.int32, device=dev)
    needU = needU.scatter_add_(1, pos, valid.to(torch.int32))[:, :U] > 0

    latU = state.latest[:, g] & uvalid[None, :]
    dirU = state.dirty[:, g] & uvalid[None, :]
    lastU = state.last_access[:, g]

    # Phase A: on-demand update push
    need_anyU = needU.any(dim=0)
    sole = needU & (needU.sum(dim=0) == 1)[None, :]
    need_other = need_anyU[None, :] & ~sole
    pushers = dirU & need_other
    update_push = pushers.sum(dim=1, dtype=torch.int32)
    pushed = pushers.any(dim=0)
    multi = pushers.sum(dim=0) > 1
    latU = latU & ~(pushed[None, :] & ~pushers) & ~multi[None, :]
    dirU = dirU & ~pushers

    # Phase B: miss pull
    miss = needU & ~latU
    miss_pull = miss.sum(dim=1, dtype=torch.int32)
    latU = latU | needU

    # Phase C: train
    dirU = dirU | needU
    latU = latU & ~(need_anyU[None, :] & ~needU)
    lastU = torch.where(needU, step, lastU)

    # scatter the touched columns back; pad columns write a scratch column
    gs = torch.where(uvalid, uids, V)
    latest = _set_cols(state.latest, gs, latU)
    dirty = _set_cols(state.dirty, gs, dirU)
    last_access = _set_cols(state.last_access, gs, lastU)

    # optional LRU capacity: strict cut over the bounded candidate set
    # (previous survivors + this step's ids); see the reference for why it
    # equals the dense full-vocab cut
    evict_push = torch.zeros((n,), dtype=torch.int32, device=dev)
    slots = state.slots
    if capacity is not None and capacity < V:
        if slots.shape[1] < capacity + L:
            raise ValueError(
                f"slot buffer {slots.shape[1]} < capacity+L = {capacity + L}; "
                "init the state with esd_sparse_init(..., capacity, max_ids=L)")
        S = slots.shape[1]
        # candidates: this step's ids (pinned) + previous survivors with
        # duplicates of this step's ids masked out
        need_sorted = torch.sort(torch.where(valid, need_ids, _I32_MAX),
                                 dim=1).values
        at = torch.searchsorted(need_sorted, slots).clamp(0, L - 1)
        hit = torch.gather(need_sorted, 1, at)
        slot_cand = torch.where((hit == slots) & (slots >= 0), -1, slots)
        cand = torch.cat([torch.where(valid, need_ids, -1), slot_cand],
                         dim=1)                                    # (n, T)
        cvalid = cand >= 0
        gc = cand.clamp(0, V - 1).long()
        la_c = torch.where(cvalid, torch.gather(last_access, 1, gc), -1)
        sla, sid = _lexsort2(la_c, cand)
        T = cand.shape[1]

        # evicted zone: valid, non-pinned entries directly below the
        # top-capacity block (never more than 2L evictions per step)
        zone = slice(T - capacity - 2 * L, T - capacity)
        ev = (sla[:, zone] >= 0) & (sla[:, zone] < step)   # pinned: la==step
        ev_ids = torch.where(ev, sid[:, zone], V)
        egc = ev_ids.clamp(max=V - 1).long()
        lat_e = torch.gather(latest, 1, egc) & ev
        dr_e = torch.gather(dirty, 1, egc) & ev
        evict_push = (lat_e & dr_e).sum(dim=1, dtype=torch.int32)
        latest = _clear_at(latest, ev_ids)
        dirty = _clear_at(dirty, ev_ids)

        # new slots: the kept suffix = top-capacity block plus any pinned
        # spill right below it (only when a batch exceeds capacity)
        top_la, top_id = sla[:, T - S:], sid[:, T - S:]            # (n, S)
        keepm = (top_la >= 0) & (
            (torch.arange(S, device=dev) >= S - capacity)[None, :]
            | (top_la == step))
        slots = torch.where(keepm, top_id, -1)

    new = SparseEsdState(latest.contiguous(), dirty.contiguous(),
                         last_access.contiguous(), slots, step)
    counts = {"miss_pull": miss_pull, "update_push": update_push,
              "evict_push": evict_push}
    if staged is not None:
        stagedU = staged[g] & uvalid
        pre = (miss & stagedU[None, :]).sum(dim=1, dtype=torch.int32)
        counts["prefetch_hit"] = pre
        counts["demand_miss"] = miss_pull - pre
    return new, counts


def need_ids_list(local_samples: torch.Tensor) -> torch.Tensor:
    """(n, L) padded unique-id lists from every worker's post-exchange
    samples (n, R, F): L = R * F, sorted, PAD = -1, as
    :func:`esd_state_update_sparse` requires."""
    n = local_samples.shape[0]
    flat = local_samples.reshape(n, -1)
    u = unique_padded(torch.where(flat >= 0, flat, _I32_MAX), _I32_MAX)
    return torch.where(u == _I32_MAX, -1, u).to(torch.int32)
