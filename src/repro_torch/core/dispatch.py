"""ESD on the device: Alg. 1 cost, Alg. 2 dispatch and the cache state
machines of the training step, in PyTorch.

The counterpart of the JAX package's ``core/dispatch_tpu.py`` (named for
what it does here, not for the TPU).  The reference runs one shard per
device under ``shard_map``; the port runs the ``n`` workers of a step on
one device with the worker as a leading tensor dimension, and each
worker's decision stays independent of the others', as under
``shard_map``.  Ported for the training step:

  * Alg. 1 (:func:`esd_cost_matrix`): always a pooled lookup of a per-id
    cost table on B1 (:mod:`repro_torch.kernels.ops`), so card and CPU
    sum in one order: the compact touched-ids table, priced per shard's
    link with a multi-PS partition, or the dense (V, n) table.  The
    n workers' matrices come from one launch instead
    (:func:`repro_torch.kernels.ops.cost_matrix_batched_kernel`, the
    same bits) wherever that route's inputs allow
    (:func:`esd_cost_matrices`, which decide, the stale re-score and the
    commit-time repair call);
  * Alg. 2 (:func:`hybrid_dispatch`): the top ``floor(k * alpha)``
    regret rows go to the eps-scaled auction (:func:`auction_fixed`:
    every worker's auction in one launch of the fused auction kernel,
    a warp or a block each by the auction's shape), the rest to the
    greedy
    :func:`heu_dispatch`.  The greedy scans and the auction's straggler
    placement are sequential over samples; they run on the host over
    small integer arrays, in the reference's order;
  * :func:`esd_dispatch`, the one-call decide and exchange;
  * the pipelined step's repair of a stale assignment
    (:func:`changed_samples_mask`, :func:`esd_reassign`, the same
    host-side capped scan);
  * the two cache engines: the dense (n, V) planes (:class:`EsdState`,
    :func:`esd_state_update`, :func:`need_matrix`) and the sparse,
    touched-ids one (:class:`SparseEsdState`,
    :func:`esd_state_update_sparse`, :func:`need_ids_list`), with the
    multi-PS counts, per-PS capacities and :func:`need_ids_local`.

Multi-PS (:class:`repro_torch.ps.PsPartition`): ids and state planes
live in the PS-linearized space (``part.to_linear``), the link times
are (n, n_ps), a miss or a push costs the owning shard's link, and
``n_ps == 1`` is the single-PS path bit for bit.

Every argsort is stable, as the reference's.  A ``mode="drop"`` scatter
of the reference lands in a scratch slot past the end here and is cut
off.  Ids stay int32 in state and outputs; indexing uses int64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..exchange.ragged import ragged_exchange_many
from ..kernels import auction as KA
from ..kernels.ops import (cost_matrix_batched_kernel, cost_matrix_kernel,
                           cost_matrix_sparse_kernel,
                           cost_matrix_sparse_ps_kernel)
from ..obs.trace import get_tracer
from .cost import unique_padded

__all__ = ["heu_dispatch", "changed_samples_mask", "esd_reassign",
           "auction_fixed", "hybrid_dispatch", "dispatch_cap",
           "exchange_budget", "esd_cost_matrix", "esd_cost_matrices",
           "esd_decide",
           "esd_dispatch", "EsdState", "esd_init", "esd_state_update",
           "need_matrix", "SparseEsdState", "esd_sparse_init",
           "esd_state_update_sparse", "need_ids_list", "need_ids_local"]

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
    cache states (either engine's) — exactly the rows whose stale cost can differ from
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
    B auctions then run in one launch of the fused auction kernel (a
    warp or a block each, :func:`repro_torch.kernels.auction.solve_route`),
    every phase's rounds tested for an unassigned row before each round
    on the device, at most ``rounds_per_phase`` a phase.
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
    int32.

    Spans: ``decide.auction`` (the regret sort, the gather, the eps
    table and the auction's launch) with ``warp``, the auctions that
    took the warp route (B or 0), ``decide.auction_wait`` (the host's
    wait for the auction's result), ``decide.straggler`` with ``rows``,
    the rows the auction left (only when it left some), and
    ``decide.greedy``."""
    tr = get_tracer()
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
        with tr.span("decide.greedy"):
            return out(torch.stack([heu_dispatch(C[b], cap)
                                    for b in range(B)]))
    with tr.span("decide.auction") as sp:
        order = torch.argsort(-_regret(C), dim=1, stable=True)     # (B, k)
        opt_idx, heu_idx = order[:, :opt_rows], order[:, opt_rows:]
        C_opt = torch.gather(C, 1,
                             opt_idx[:, :, None].expand(B, opt_rows, n))
        a_opt = auction_fixed(C_opt, opt_cap)
        placed = a_opt >= 0
        if tr.enabled:
            sp.args["warp"] = KA.warp_auctions(C_opt, opt_cap)
    with tr.span("decide.auction_wait"):
        all_placed = bool(placed.all())
    if not all_placed:
        # stragglers: each unplaced row, in order, takes its cheapest
        # worker with spare capacity (the reference's capacity-respecting
        # scan changes nothing at placed rows, so it runs over the rest)
        a_host = a_opt.tolist()
        rows = sum(row.count(-1) for row in a_host)
        with tr.span("decide.straggler", rows=rows):
            pref = torch.argsort(C_opt, dim=2, stable=True).tolist()
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
        with tr.span("decide.greedy"):
            for b in range(B):
                workload = torch.bincount(a_opt[b].long(), minlength=n)
                a_heu = heu_dispatch(C[b][heu_idx[b]], cap,
                                     workload=workload)
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


def esd_cost_matrix(samples: torch.Tensor, state, t_tran: torch.Tensor,
                    col_bias: Optional[torch.Tensor] = None,
                    sparse_cost: bool = True, part=None) -> torch.Tensor:
    """One worker's (m, n) Alg. 1 cost matrix under ``state``, through
    the pooled-lookup kernel: with ``part`` of ``n_ps > 1`` the touched
    ids priced at their shards' links (``t_tran`` (n, n_ps), samples and
    planes PS-linearized), else the compact touched-ids table, or with
    ``sparse_cost=False`` the dense (V, n) table.

    ``col_bias`` (elastic clusters, :func:`repro_torch.elastic.
    cost_column_bias`): an (n,) per-worker additive term — straggler
    excess compute, or the finite dead-worker penalty — added after the
    kernel in the cost's dtype.  ``None`` and an all-zero bias give the
    same bits (costs are >= 0, so ``C + 0.0`` is identity)."""
    if part is not None and part.n_ps > 1:
        C = cost_matrix_sparse_ps_kernel(samples, state.latest, state.dirty,
                                         t_tran, part)
    else:
        kern = cost_matrix_sparse_kernel if sparse_cost else cost_matrix_kernel
        C = kern(samples, state.latest, state.dirty, t_tran)
    if col_bias is not None:
        C = C + col_bias[None, :].to(C.dtype)
    return C


def esd_cost_matrices(samples: torch.Tensor, state, t_tran: torch.Tensor,
                      col_bias: Optional[torch.Tensor] = None,
                      sparse_cost: bool = True, part=None):
    """All n workers' Alg. 1 matrices, ``(C (n, m, n), fused)``: one
    launch of :func:`repro_torch.kernels.ops.cost_matrix_batched_kernel`
    where its inputs allow (one PS, ``part`` None or of ``n_ps == 1``;
    the sparse cost; (n,) link times; as many workers as it takes), with
    ``fused = n``; else :func:`esd_cost_matrix` worker by worker, with
    ``fused = 0``.  Both give the same bits."""
    C = None
    if (sparse_cost and (part is None or part.n_ps == 1)
            and t_tran.dim() == 1):
        C = cost_matrix_batched_kernel(samples, state.latest, state.dirty,
                                       t_tran)
    if C is None:
        return torch.stack([esd_cost_matrix(s, state, t_tran, col_bias,
                                            sparse_cost, part)
                            for s in samples]), 0
    if col_bias is not None:
        C = C + col_bias[None, None, :].to(C.dtype)
    return C, samples.shape[0]


def esd_decide(samples: torch.Tensor, state, t_tran: torch.Tensor,
               alpha: float, cap_slack: float = 0.0, with_cost: bool = False,
               col_bias: Optional[torch.Tensor] = None,
               cap: Optional[int] = None, sparse_cost: bool = True,
               part=None):
    """Alg. 1 + Alg. 2 for every worker: samples (n, m, F), one row
    block per worker -> assign (n, m) int32, and with ``with_cost`` also
    each worker's Alg.-1 objective of its assignment (n,) f32.
    ``sparse_cost`` and ``part`` pick the cost route
    (:func:`esd_cost_matrices`).

    Elastic clusters: ``col_bias`` biases the cost columns (see
    :func:`esd_cost_matrix`) and ``cap`` overrides the default
    ``dispatch_cap(m, n, cap_slack)`` — a churn-tolerant driver raises
    the static capacity so the survivors of the worst planned
    simultaneous loss can absorb every sample.

    Span: ``decide.cost``, the n workers' Alg.-1 matrices
    (:func:`esd_cost_matrices`); its ``fused`` counts the workers'
    matrices the one batched launch built (n or 0)."""
    n, m, _ = samples.shape
    tr = get_tracer()
    with tr.span("decide.cost") as sp:
        C, fused = esd_cost_matrices(samples, state, t_tran, col_bias,
                                     sparse_cost, part)
        if tr.enabled:
            sp.args["fused"] = fused
    if cap is None:
        cap = dispatch_cap(m, n, cap_slack)
    assign = hybrid_dispatch(C, m, alpha, cap=cap)
    if with_cost:
        alg1 = torch.gather(C, 2, assign.long()[:, :, None])[:, :, 0].sum(1)
        return assign, alg1
    return assign


def esd_dispatch(samples: torch.Tensor, state, t_tran: torch.Tensor,
                 alpha: float, sparse_cost: bool = True, part=None,
                 cap_slack: float = 0.0, exchange: str = "padded",
                 col_bias: Optional[torch.Tensor] = None):
    """Dispatch every worker's samples (n, m, F): :func:`esd_decide`,
    then the exchange.  Returns ``(exchanged, assign)``: the samples
    each worker received (n, out_rows, F) and the assignment (n, m).

    ``exchange="padded"`` sends exactly m/n samples from every worker
    to every worker (needs ``cap_slack == 0``); ``"ragged"`` is the
    budgeted executor (one launch of the pack kernel): with ``cap_slack
    == 0`` its budget is m/n and it equals the padded path; with
    ``cap_slack > 0`` a worker may take up to ``dispatch_cap(m, n,
    cap_slack)`` samples a source and the exchanged block is ``n *
    exchange_budget`` rows, the valid rows first and PAD (-1) after.
    ``sparse_cost=False`` prices through the dense (V, n) table
    (:func:`repro_torch.kernels.ops.cost_matrix_kernel`).  Multi-PS:
    pass ``part`` and (n, n_ps) link times, samples and planes
    PS-linearized."""
    n, m, F = samples.shape
    if exchange not in ("padded", "ragged"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if cap_slack > 0.0 and exchange != "ragged":
        raise ValueError("cap_slack > 0 needs exchange='ragged' (the padded "
                         "all_to_all requires equal m/n groups)")
    assign = esd_decide(samples, state, t_tran, alpha,
                        sparse_cost=sparse_cost, part=part,
                        cap_slack=cap_slack, col_bias=col_bias)
    cap = dispatch_cap(m, n, cap_slack)
    if exchange == "ragged":
        budget = cap if cap_slack <= 0.0 else exchange_budget(cap, m)
        out_rows = m if cap_slack <= 0.0 else n * budget
        (out,), _, _, _ = ragged_exchange_many((samples,), assign, budget,
                                               out_rows)
        return out, assign
    order = torch.argsort(assign, dim=1, stable=True)             # (n, m)
    routed = torch.gather(samples, 1, order[:, :, None].expand(n, m, F))
    blocks = routed.reshape(n, n, m // n, F)       # [source, dest, row, F]
    return blocks.transpose(0, 1).reshape(n, m, F), assign


# --------------------------------------------------------------------------
# dense cache state + accounting (the (n, V) planes, every id every step)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class EsdState:
    """Replicated cache state of the dense engine: every plane (n, V)."""
    latest: torch.Tensor        # (n, V) bool — latest version resident
    dirty: torch.Tensor         # (n, V) bool — unsynced local gradient
    last_access: torch.Tensor   # (n, V) int32
    step: torch.Tensor          # () int32


def esd_init(n_workers: int, vocab: int, device="cpu") -> EsdState:
    return EsdState(
        torch.zeros((n_workers, vocab), dtype=torch.bool, device=device),
        torch.zeros((n_workers, vocab), dtype=torch.bool, device=device),
        torch.zeros((n_workers, vocab), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def esd_state_update(state: EsdState, need: torch.Tensor,
                     capacity: Optional[int] = None, staged=None):
    """One BSP iteration of the cache protocol on the dense planes
    (reference ``esd_state_update``).

    need: (n, V) bool, the ids each worker trains this iteration (after
    the exchange; :func:`need_matrix`).  Returns (new_state, counts) with
    per-worker ``miss_pull``, ``update_push`` and ``evict_push`` (n,)
    int32.  ``capacity`` keeps each worker's ``capacity`` most recent
    ids (ties by id, the larger kept) plus this step's; 0 keeps this
    step's alone.  ``staged``, the (V,) bool membership of the prefetch
    plane, splits the misses into ``prefetch_hit`` and ``demand_miss``;
    the state is the same with or without it.
    """
    latest, dirty = state.latest, state.dirty
    n, V = need.shape
    step = state.step + 1

    # Phase A: on-demand update push
    need_any = need.any(dim=0)
    sole = need & (need.sum(dim=0) == 1)[None, :]
    need_other = need_any[None, :] & ~sole
    pushers = dirty & need_other
    update_push = pushers.sum(dim=1, dtype=torch.int32)
    pushed = pushers.any(dim=0)
    multi = pushers.sum(dim=0) > 1
    latest = latest & ~(pushed[None, :] & ~pushers) & ~multi[None, :]
    dirty = dirty & ~pushers

    # Phase B: miss pull
    miss = need & ~latest
    miss_pull = miss.sum(dim=1, dtype=torch.int32)
    latest = latest | need

    # Phase C: train
    dirty = dirty | need
    latest = latest & ~(need_any[None, :] & ~need)
    last_access = torch.where(need, step, state.last_access)

    # optional LRU capacity: evict all but the `capacity` most recent
    evict_push = torch.zeros((n,), dtype=torch.int32, device=need.device)
    if capacity is not None and capacity < V:
        if capacity == 0:
            keep = need
        else:
            # the strict cut on (last_access, id): the rows are in id
            # order, so one stable sort on last_access gives the
            # reference's two-key order
            sla, sid = torch.sort(last_access, dim=1, stable=True)
            kth_la = sla[:, V - capacity][:, None]
            kth_id = sid[:, V - capacity][:, None]
            ids_row = torch.arange(V, device=need.device)[None, :]
            keep = (last_access > kth_la) | ((last_access == kth_la)
                                             & (ids_row >= kth_id))
            keep = keep | need            # pinned
        evicted = latest & ~keep
        evict_push = (evicted & dirty).sum(dim=1, dtype=torch.int32)
        dirty = dirty & keep
        latest = latest & keep

    new = EsdState(latest, dirty, last_access, step)
    counts = {"miss_pull": miss_pull, "update_push": update_push,
              "evict_push": evict_push}
    if staged is not None:
        pre = (miss & staged[None, :]).sum(dim=1, dtype=torch.int32)
        counts["prefetch_hit"] = pre
        counts["demand_miss"] = miss_pull - pre
    return new, counts


def need_matrix(local_samples: torch.Tensor, vocab: int) -> torch.Tensor:
    """(n, V) bool need planes from every worker's post-exchange samples
    (n, R, F): worker j's row marks the ids it received (PAD ignored)."""
    n = local_samples.shape[0]
    flat = local_samples.reshape(n, -1)
    idx = torch.where(flat >= 0, flat, vocab).long()          # PAD -> V
    mine = torch.zeros((n, vocab + 1), dtype=torch.bool,
                       device=local_samples.device)
    return mine.scatter_(1, idx, True)[:, :vocab]


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
                    capacity: Optional[Union[int, Sequence[int]]] = None,
                    max_ids: int = 0, device="cpu") -> SparseEsdState:
    """``max_ids`` = L, the per-worker padded id-list width the state
    will be stepped with (the slot buffer holds S = capacity + L).
    ``capacity`` may be a per-PS sequence (one worker-cache budget a
    parameter server, see :func:`esd_state_update_sparse`); the slot
    buffer then holds one (cap_p + L)-wide segment a shard."""
    if capacity is not None and np.ndim(capacity) > 0:
        S = int(sum(int(c) + max_ids for c in capacity))
    else:
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


def _lru_cut(slots: torch.Tensor, need: torch.Tensor,
             last_access: torch.Tensor, latest: torch.Tensor,
             dirty: torch.Tensor, capacity: int, step: torch.Tensor):
    """The strict LRU cut over the bounded candidate set: this step's ids
    ``need`` (n, L), PAD = -1, pinned, and the previous survivors
    ``slots`` (n, S), S >= capacity + L.  Returns ``(latest, dirty,
    lost, ev_ids, slots)``: the planes with the evicted ids cleared,
    ``lost`` (n, 2L) the evicted ids that were latest and dirty (pushed
    back), ``ev_ids`` (n, 2L) the evicted ids (V where none) and the new
    survivors (n, S)."""
    L = need.shape[1]
    V = latest.shape[1]
    S = slots.shape[1]
    valid = need >= 0
    # candidates: this step's ids + previous survivors with duplicates of
    # this step's ids masked out
    need_sorted = torch.sort(torch.where(valid, need, _I32_MAX),
                             dim=1).values
    at = torch.searchsorted(need_sorted, slots.contiguous()).clamp(0, L - 1)
    hit = torch.gather(need_sorted, 1, at)
    slot_cand = torch.where((hit == slots) & (slots >= 0), -1, slots)
    cand = torch.cat([need, slot_cand], dim=1)                     # (n, T)
    gc = cand.clamp(0, V - 1).long()
    la_c = torch.where(cand >= 0, torch.gather(last_access, 1, gc), -1)
    sla, sid = _lexsort2(la_c, cand)
    T = cand.shape[1]

    # evicted zone: valid, non-pinned entries directly below the
    # top-capacity block (never more than 2L evictions per step)
    zone = slice(T - capacity - 2 * L, T - capacity)
    ev = (sla[:, zone] >= 0) & (sla[:, zone] < step)   # pinned: la == step
    ev_ids = torch.where(ev, sid[:, zone], V)
    egc = ev_ids.clamp(max=V - 1).long()
    lost = torch.gather(latest, 1, egc) & torch.gather(dirty, 1, egc) & ev

    # new slots: the kept suffix = top-capacity block plus any pinned
    # spill right below it (only when a batch exceeds capacity)
    top_la, top_id = sla[:, T - S:], sid[:, T - S:]                # (n, S)
    keepm = (top_la >= 0) & (
        (torch.arange(S, device=slots.device) >= S - capacity)[None, :]
        | (top_la == step))
    return (_clear_at(latest, ev_ids), _clear_at(dirty, ev_ids), lost,
            ev_ids, torch.where(keepm, top_id, -1))


def _per_shard(mask: torch.Tensor, shard: torch.Tensor, n_ps: int
               ) -> torch.Tensor:
    """(n, n_ps) int32: the set bits of ``mask`` (n, X) counted by the
    shard of their column (``shard`` (X,) or (n, X); out-of-range shards
    count nowhere)."""
    hit = shard[..., None] == torch.arange(n_ps, device=mask.device)
    return (mask[..., None] & hit).sum(dim=1, dtype=torch.int32)


def esd_state_update_sparse(state: SparseEsdState, need_ids: torch.Tensor,
                            capacity: Optional[Union[int, Sequence[int]]]
                            = None, part=None, staged=None):
    """One BSP iteration of the cache protocol, driven by touched ids
    (reference ``esd_state_update_sparse``): the counts and state of
    :func:`esd_state_update`.

    need_ids: (n, L) int32, the ids each worker trains this iteration,
    unique within each row, PAD = -1 (see :func:`need_ids_list`).
    Returns (new_state, counts) with per-worker ``miss_pull``,
    ``update_push`` and ``evict_push`` (n,) int32.  ``staged``, the
    (V,) bool membership of the prefetch plane
    (:func:`repro_torch.pipeline.prefetch.staged_membership`), splits
    the misses into ``prefetch_hit`` (the row was staged) and
    ``demand_miss``; the state is the same with or without it.

    With ``part`` (a :class:`repro_torch.ps.PsPartition`; ids and planes
    in its PS-linearized space, planes ``part.linear_size`` wide) the
    counts also hold the per-(worker, PS) ``{miss_pull, update_push,
    evict_push}_ps`` (n, n_ps); the transition is the same.
    ``capacity`` may then be a length-``n_ps`` sequence of per-PS
    budgets: each worker keeps at most ``capacity[p]`` ids of shard
    ``p``, the cut run shard by shard over its own slot segment (init
    the state with the same sequence).  A plain int is the single-budget
    path, bit for bit.
    """
    n, L = need_ids.shape
    V = state.latest.shape[1]
    if part is not None and V != part.linear_size:
        raise ValueError(
            f"state plane width {V} != part.linear_size {part.linear_size}: "
            "multi-PS state runs on the PS-linearized id space")
    capacity_ps = None
    if capacity is not None and np.ndim(capacity) > 0:
        if part is None:
            raise ValueError("per-PS capacity budgets need part=")
        if len(capacity) != part.n_ps:
            raise ValueError(f"capacity_ps has {len(capacity)} entries for "
                             f"n_ps = {part.n_ps}")
        capacity_ps = tuple(int(c) for c in capacity)
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
    evict_push_ps = (torch.zeros((n, part.n_ps), dtype=torch.int32,
                                 device=dev) if part is not None else None)
    slots = state.slots
    if capacity_ps is not None:
        # per-PS budgets: the same cut, shard by shard, over that shard's
        # slot segment and this step's ids homed there
        offs = np.cumsum([0] + [c + L for c in capacity_ps])
        if slots.shape[1] < offs[-1]:
            raise ValueError(
                f"slot buffer {slots.shape[1]} < sum(cap_p + L) = {offs[-1]}; "
                "init the state with esd_sparse_init(..., capacity_ps, "
                "max_ids=L)")
        shard_need = part.shard_of_linear(torch.where(valid, need_ids, 0))
        segs, ev_counts = [], []
        for p, cap_p in enumerate(capacity_ps):
            need_p = torch.where(valid & (shard_need == p), need_ids, -1)
            latest, dirty, lost, _, seg = _lru_cut(
                slots[:, offs[p]:offs[p + 1]], need_p, last_access, latest,
                dirty, cap_p, step)
            ev_counts.append(lost.sum(dim=1, dtype=torch.int32))
            segs.append(seg)
        evict_push = sum(ev_counts)
        evict_push_ps = torch.stack(ev_counts, dim=1)
        pad = slots.shape[1] - int(offs[-1])
        slots = torch.cat(segs + [torch.full((n, pad), -1, dtype=slots.dtype,
                                             device=dev)], dim=1)
    elif capacity is not None and capacity < V:
        if slots.shape[1] < capacity + L:
            raise ValueError(
                f"slot buffer {slots.shape[1]} < capacity+L = {capacity + L}; "
                "init the state with esd_sparse_init(..., capacity, max_ids=L)")
        latest, dirty, lost, ev_ids, slots = _lru_cut(
            slots, torch.where(valid, need_ids, -1), last_access, latest,
            dirty, capacity, step)
        evict_push = lost.sum(dim=1, dtype=torch.int32)
        if part is not None:
            # the sentinel V's shard is out of range (n_ps > 1) or 0 (n_ps
            # = 1); either way ``lost`` is False there
            evict_push_ps = _per_shard(lost, part.shard_of_linear(ev_ids),
                                       part.n_ps)

    new = SparseEsdState(latest.contiguous(), dirty.contiguous(),
                         last_access.contiguous(), slots, step)
    counts = {"miss_pull": miss_pull, "update_push": update_push,
              "evict_push": evict_push}
    if staged is not None:
        stagedU = staged[g] & uvalid
        pre = (miss & stagedU[None, :]).sum(dim=1, dtype=torch.int32)
        counts["prefetch_hit"] = pre
        counts["demand_miss"] = miss_pull - pre
    if part is not None:
        # the breakdown on the touched universe; sentinel columns never
        # hold a miss or a pusher, so their shard is irrelevant
        shard_u = part.shard_of_linear(uids)
        counts["miss_pull_ps"] = _per_shard(miss, shard_u, part.n_ps)
        counts["update_push_ps"] = _per_shard(pushers, shard_u, part.n_ps)
        counts["evict_push_ps"] = evict_push_ps
    return new, counts


def need_ids_list(local_samples: torch.Tensor) -> torch.Tensor:
    """(n, L) padded unique-id lists from every worker's post-exchange
    samples (n, R, F): L = R * F, sorted, PAD = -1, as
    :func:`esd_state_update_sparse` requires."""
    n = local_samples.shape[0]
    flat = local_samples.reshape(n, -1)
    u = unique_padded(torch.where(flat >= 0, flat, _I32_MAX), _I32_MAX)
    return torch.where(u == _I32_MAX, -1, u).to(torch.int32)


def need_ids_local(need_ids: torch.Tensor, part) -> torch.Tensor:
    """(n_ps, n, L) per-PS local-row need lists from PS-linearized (n, L)
    ``need_ids`` (PAD = -1): row ``[p, j]`` holds the local rows of shard
    ``p`` that worker ``j`` needs — the pull and push list each parameter
    server receives.  Rows stay sorted and unique with PAD = -1, like
    :func:`need_ids_list`."""
    shard = part.shard_of_linear(need_ids)
    local = need_ids - shard * part.max_rows             # valid slots only
    out = []
    for p in range(part.n_ps):
        vals = torch.where((need_ids >= 0) & (shard == p), local, _I32_MAX)
        vals = torch.sort(vals, dim=1).values
        out.append(torch.where(vals == _I32_MAX, -1, vals))
    return torch.stack(out).to(torch.int32)
