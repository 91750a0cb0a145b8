"""Step builders: the LM train step and the stages of the DLRM ESD
training step.

The counterpart of the JAX package's ``launch/steps.py``
(``make_train_step`` for the LM, and ``make_esd_exchange``,
``raise_on_overflow``, ``make_dlrm_esd_stages`` and
``make_dlrm_repair_stage`` for the non-elastic, single-PS case).  The
reference's stages run one shard per device under ``shard_map``; here
the ``n`` workers share one device and a stage's global ``(k, ...)``
batch is split by rows, worker ``i`` holding rows ``[i * m, (i + 1) *
m)``.  ``lax.all_to_all`` becomes a transpose of the stacked send
blocks, ``all_gather`` a stack over workers and ``psum`` a sum over
them.
"""
from __future__ import annotations

import torch

from ..core.dispatch import (changed_samples_mask, dispatch_cap,
                             esd_cost_matrix, esd_decide, esd_reassign,
                             esd_state_update_sparse, exchange_budget,
                             need_ids_list)
from ..exchange.ragged import ragged_exchange_many
from ..models import api
from ..quant.codecs import get_codec

__all__ = ["make_train_step", "make_esd_exchange", "raise_on_overflow",
           "make_dlrm_esd_stages", "make_dlrm_repair_stage"]


def make_train_step(cfg, model, optimizer):
    """The LM train step (the reference's with ``remat=False``, as its LM
    driver runs it): ``step(batch) -> loss`` takes the loss and its
    gradients through ``api.train_loss`` and copies ``optimizer``'s new
    values into ``model``'s parameters in place."""
    params = list(model.parameters())
    opt_state = optimizer.init(params)

    def step(batch):
        nonlocal opt_state
        loss = api.train_loss(model, cfg, batch)
        grads = torch.autograd.grad(loss, params)
        new, opt_state = optimizer.update(list(grads), opt_state, params)
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        return loss.detach()

    return step


def make_esd_exchange(mode: str, n: int, m: int, budget: int | None = None,
                      out_rows: int | None = None, codec=None):
    """Row-exchange function for the ESD step: ``route(a, assign)`` moves
    every worker's (n, m, ...) rows (sample ids, dense features, labels)
    to the worker each sample was assigned to (assign: (n, m)) and
    returns ``(out (n, out_rows, ...), overflow)``.  Given a tuple of
    such arrays it moves them all over the one assignment and returns
    ``(outs, overflow)``.

    ``mode="padded"`` is the fixed m/n all-to-all baseline (no kernel);
    ``mode="ragged"`` is the budgeted executor, whose pack of all the
    arrays is one launch of the pack kernel.  With the default ``budget
    = m // n`` and ``out_rows = m`` the two agree exactly; a relaxed
    capacity passes ``exchange_budget`` and ``out_rows = n * budget``,
    and the rows past each worker's valid prefix come back as -1.

    ``codec`` (ragged only) quantizes the float (n, m, F) payload, the
    dense features, on the wire
    (:func:`repro_torch.exchange.ragged.ragged_exchange_many`); sample
    ids and labels always travel exact.
    """
    if mode not in ("padded", "ragged"):
        raise ValueError(f"unknown exchange mode {mode!r}")
    codec = get_codec(codec)
    if codec is not None and mode != "ragged":
        raise ValueError("codec exchange needs mode='ragged'")
    if mode == "padded":
        if budget not in (None, m // n) or out_rows not in (None, m):
            raise ValueError("padded exchange is fixed-shape: budget/out_rows "
                             "cannot deviate from m/n and m")

        def route_all(arrays, assign):
            order = torch.argsort(assign, dim=1, stable=True)      # (n, m)
            outs = []
            for a in arrays:
                idx = order.reshape(order.shape + (1,) * (a.dim() - 2))
                routed = torch.gather(a, 1, idx.expand(a.shape))
                blocks = routed.reshape((n, n, m // n) + a.shape[2:])
                outs.append(blocks.transpose(0, 1).reshape(a.shape))
            return outs, torch.zeros((), dtype=torch.int32,
                                     device=assign.device)
    else:
        budget = m // n if budget is None else budget
        out_rows = m if out_rows is None else out_rows

        def route_all(arrays, assign):
            # every array rides the one assignment and budget: one pack
            # launch, and one overflow counter covers them all
            outs, _, _, overflow = ragged_exchange_many(
                arrays, assign, budget, out_rows, codec=codec)
            return outs, overflow

    def route(a, assign):
        many = isinstance(a, (tuple, list))
        outs, overflow = route_all(tuple(a) if many else (a,), assign)
        return (tuple(outs) if many else outs[0]), overflow

    return route


def raise_on_overflow(counts: dict) -> None:
    """Host-side guard for the ragged wire: an undersized budget drops
    rows, so the driver checks the step's ``exchange_overflow`` counter
    and fails loudly instead of training on a truncated batch."""
    ov = counts.get("exchange_overflow")
    if ov is None:
        return
    ov = int(ov)
    if ov:
        raise RuntimeError(
            f"ragged exchange dropped {ov} rows: the per-link budget is "
            f"smaller than the dispatch capacity (raise cap_slack's budget "
            f"or fix the assignment)")


def make_dlrm_esd_stages(n: int, m: int, t_tran: torch.Tensor, alpha: float,
                         *, exchange: str = "padded",
                         cap_slack: float = 0.0,
                         capacity: int | None = None, codec=None):
    """Stage functions of the DLRM ESD step (reference
    ``make_dlrm_esd_stages``, non-elastic, single PS, sparse engine):

      decide(esd_state, sparse)                    -> (assign (k,), alg1)
      advance(esd_state, sparse, dense, labels, assign, staged=None)
          -> ((sparse', dense', labels'), new_esd_state, counts)
      realized_cost(esd_state, sparse, assign)     -> alg1

    ``sparse``/``dense``/``labels`` are the global (k, ...) batch, k = n
    * m.  ``decide`` is Alg. 1 + Alg. 2 per worker; ``advance`` moves the
    samples over the selected wire path and runs the cache-state
    machine; ``staged``, the prefetch plane's (V,) membership, splits
    the step's misses into ``prefetch_hit`` and ``demand_miss`` counts
    (accounting only).  With ``cap_slack > 0`` (needs
    ``exchange="ragged"``) the exchanged arrays come back with
    ``out_rows = n * exchange_budget`` rows per worker, valid rows first
    and -1 after (pair with the PAD-masked loss).  ``codec`` (needs
    ``exchange="ragged"``) sends the dense features over the quantized
    wire.  Returns ``(decide, advance, realized_cost, out_rows)``.
    """
    if cap_slack > 0.0 and exchange != "ragged":
        raise ValueError("cap_slack > 0 needs exchange='ragged' (the padded "
                         "all_to_all requires equal m/n groups)")
    if get_codec(codec) is not None and exchange != "ragged":
        raise ValueError("codec exchange needs exchange='ragged'")
    cap = dispatch_cap(m, n, cap_slack)
    budget = m // n if cap_slack <= 0.0 else exchange_budget(cap, m)
    out_rows = m if cap_slack <= 0.0 else n * budget
    if exchange == "ragged":
        route = make_esd_exchange(exchange, n, m, budget=budget,
                                  out_rows=out_rows, codec=codec)
    else:
        route = make_esd_exchange(exchange, n, m)

    def split(a):
        return a.reshape((n, m) + a.shape[1:])

    def decide(esd_state, sparse):
        assign, alg1 = esd_decide(split(sparse), esd_state, t_tran, alpha,
                                  cap_slack=cap_slack, with_cost=True)
        return assign.reshape(-1), alg1.sum()

    def advance(esd_state, sparse, dense, labels, assign, staged=None):
        (s2, d2, l2), overflow = route(
            (split(sparse), split(dense), split(labels)), split(assign))
        need = need_ids_list(s2)
        new_state, counts = esd_state_update_sparse(esd_state, need,
                                                    capacity, staged=staged)
        counts = dict(counts)
        counts["exchange_overflow"] = overflow
        flat = lambda x: x.reshape((n * out_rows,) + x.shape[2:])
        return (flat(s2), flat(d2), flat(l2)), new_state, counts

    def realized_cost(esd_state, sparse, assign):
        s, a = split(sparse), split(assign).long()
        total = torch.zeros((), dtype=torch.float32, device=sparse.device)
        for i in range(n):
            C = esd_cost_matrix(s[i], esd_state, t_tran)
            total = total + torch.gather(C, 1, a[i][:, None])[:, 0].sum()
        return total

    return decide, advance, realized_cost, out_rows


def make_dlrm_repair_stage(n: int, m: int, t_tran: torch.Tensor, *,
                           cap_slack: float = 0.0):
    """Commit-time repair for the decide-ahead chain (reference
    ``make_dlrm_repair_stage``, single PS), per worker:

      repair(committed_state, decide_state, sparse, assign)
          -> (assign' (k,), n_reassigned)

    Flags the samples whose ids' ``latest`` or ``dirty`` columns changed
    between the decide-time state and the committed one
    (:func:`changed_samples_mask`) and re-places only those with the
    capped greedy (:func:`esd_reassign`) against the committed state's
    cost matrix; every other sample keeps its stale worker.
    ``n_reassigned`` is the flagged count over all workers (0-dim
    int32).
    """
    cap = dispatch_cap(m, n, cap_slack)

    def repair(committed_state, decide_state, sparse, assign):
        s = sparse.reshape((n, m) + sparse.shape[1:])
        flagged = changed_samples_mask(s, decide_state, committed_state)
        C = torch.stack([esd_cost_matrix(s[i], committed_state, t_tran)
                         for i in range(n)])                      # (n, m, n)
        a2, n_re = esd_reassign(C, assign.reshape(n, m), flagged, cap)
        return a2.reshape(-1), n_re

    return repair
