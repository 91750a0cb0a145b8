"""Step builders: the LM train, serve (decode) and prefill steps, and
the stages of the DLRM ESD training step.

The counterpart of the JAX package's ``launch/steps.py``
(``make_train_step``, ``make_serve_step`` and ``make_prefill_step`` for
the LM, and ``make_esd_exchange``,
``raise_on_overflow``, ``make_dlrm_esd_stages`` with its elastic
variants, multi-PS and both cache engines, and
``make_dlrm_repair_stage``; and the dry run's shape helpers
``param_shapes``, ``opt_state_shapes``, ``batch_shapes``,
``cache_shapes``, ``decode_input_shapes`` and ``input_specs``, whose
tensors lie on the ``meta`` device: shapes and dtypes, no memory).  The
reference's stages run one shard per device under ``shard_map``; here
the ``n`` workers share one device and a stage's global ``(k, ...)``
batch is split by rows, worker ``i`` holding rows ``[i * m, (i + 1) *
m)``.  ``lax.all_to_all`` becomes a transpose of the stacked send
blocks, ``all_gather`` a stack over workers and ``psum`` a sum over
them.
"""
from __future__ import annotations

import torch

from ..configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from ..core.dispatch import (changed_samples_mask, dispatch_cap,
                             esd_cost_matrices, esd_decide, esd_reassign,
                             esd_state_update, esd_state_update_sparse,
                             exchange_budget, need_ids_list, need_matrix)
from ..elastic import mask_state
from ..exchange.ragged import ragged_exchange_many
from ..models import api, backbone, whisper
from ..obs.trace import get_tracer
from ..optim import get_optimizer
from ..quant.codecs import get_codec

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "make_esd_exchange", "raise_on_overflow", "make_dlrm_esd_stages",
           "make_dlrm_repair_stage", "param_shapes", "opt_state_shapes",
           "batch_shapes", "cache_shapes", "decode_input_shapes",
           "input_specs"]


def make_train_step(cfg, model, optimizer, remat: bool = True):
    """The LM train step: ``step(batch) -> loss`` takes the loss and its
    gradients through ``api.train_loss`` (any family: the batch is
    ``api.make_train_batch``'s layout, as tensors) and copies
    ``optimizer``'s new values into ``model``'s parameters in place.
    ``remat`` (the reference's default) checkpoints each layer group
    (each whisper layer): the backward runs its forward again.  The LM
    driver passes ``remat=False``, as the reference's.
    ``step.state["opt"]`` is the optimizer's state (a checkpoint reads
    and replaces it)."""
    params = list(model.parameters())
    state = {"opt": optimizer.init(params)}

    def step(batch):
        loss = api.train_loss(model, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, params)
        new, state["opt"] = optimizer.update(list(grads), state["opt"],
                                             params)
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        return loss.detach()

    step.state = state
    return step


def make_serve_step(cfg):
    """``serve_step(params, cache, token, pos) -> (logits, cache)``: one
    decode step (:func:`repro_torch.models.api.decode_step`); ``pos`` is
    a host int."""
    def serve_step(params, cache, token, pos: int):
        return api.decode_step(params, cfg, token, cache, pos)

    return serve_step


def make_prefill_step(cfg, remat: bool = True):
    """``prefill_step(params, batch) -> logits``, without autograd: for
    the audio family :func:`~repro_torch.models.whisper.encode` of
    ``batch["frames"]`` then ``decode_train`` of ``batch["tokens"]``
    (B, S_dec, V); for the others the backbone's forward of
    ``batch["tokens"]`` behind ``batch.get("patches")`` (the VLM's
    prefix), logits over all P + S positions, unsliced, as the
    reference's.  At P + S >= 2,048 (a multiple of 512) every
    full-attention layer at hd 32, 64 or 128 runs B8's forward, and
    every ``mamba`` and ``rglru`` layer the linear-scan kernel at any S;
    whisper's bidirectional encoder takes the naive route at every
    length.  It runs without autograd, where ``remat`` (the reference's
    argument) changes nothing."""
    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.family == "audio":
                memory = whisper.encode(params, cfg, batch["frames"],
                                        remat=remat)
                return whisper.decode_train(params, cfg, batch["tokens"],
                                            memory, remat=remat)
            logits, _ = backbone.forward(params, cfg, batch["tokens"],
                                         prefix_embeds=batch.get("patches"),
                                         remat=remat)
        return logits

    return prefill_step


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
                         *, part=None, exchange: str = "padded",
                         cap_slack: float = 0.0, sparse_esd: bool = True,
                         capacity: int | None = None, codec=None,
                         elastic: bool = False, max_failures: int = 0):
    """Stage functions of the DLRM ESD step (reference
    ``make_dlrm_esd_stages``):

      decide(esd_state, sparse)                    -> (assign (k,), alg1)
      advance(esd_state, sparse, dense, labels, assign, staged=None)
          -> ((sparse', dense', labels'), new_esd_state, counts)
      realized_cost(esd_state, sparse, assign)     -> alg1

    ``sparse``/``dense``/``labels`` are the global (k, ...) batch, k = n
    * m.  ``decide`` is Alg. 1 + Alg. 2 per worker; ``advance`` moves the
    samples over the selected wire path and runs the cache-state
    machine: the sparse engine (:func:`esd_state_update_sparse` over
    :func:`need_ids_list`) or, with ``sparse_esd=False``, the dense one
    (:func:`esd_state_update` over :func:`need_matrix`); ``staged``, the
    prefetch plane's (V,) membership, splits the step's misses into
    ``prefetch_hit`` and ``demand_miss`` counts (accounting only).
    With ``cap_slack > 0`` (needs
    ``exchange="ragged"``) the exchanged arrays come back with
    ``out_rows = n * exchange_budget`` rows per worker, valid rows first
    and -1 after (pair with the PAD-masked loss).  ``codec`` (needs
    ``exchange="ragged"``) sends the dense features over the quantized
    wire.  Returns ``(decide, advance, realized_cost, out_rows)``.
    ``advance`` records the spans ``advance.exchange`` (the pack) and
    ``advance.cache`` (the cache state's update).

    Multi-PS: with ``part`` (a :class:`repro_torch.ps.PsPartition`) and
    (n, n_ps) link times every stage takes the batch's global ids to
    the PS-linearized space (``part.to_linear``) first: Alg. 1 prices a
    miss or a push at the owning shard's link, the exchanged ids (what
    train gathers from the PS-stacked tables) and the state planes
    (``part.linear_size`` wide) are linear, and the counts carry the
    per-(worker, PS) ``*_ps`` breakdown.

    ``elastic=True`` (:mod:`repro_torch.elastic`, needs
    ``exchange="ragged"``) gives the churn-tolerant stages, which take
    per-step tensors of fixed shape, so membership churn changes values,
    never shapes:

      decide(esd_state, sparse, t_arr, col_bias, active)
      advance(esd_state, sparse, dense, labels, assign, active)
      realized_cost(esd_state, sparse, assign, t_arr, col_bias, active)

    ``t_arr`` is the step's effective link times (bandwidth droop, a PS
    outage folded in), ``col_bias`` the per-worker cost bias (straggler excess
    compute; finite dead-worker penalty), ``active`` the (n,) bool
    membership mask: dead workers' state rows are masked in decide AND
    before the cache update, so their stale planes never feed phase A
    (a rejoin is cold).  The capacity is raised to ``ceil(m / (n -
    max_failures))`` so the survivors of the worst planned simultaneous
    loss can absorb every sample; a dead worker's exchanged block comes
    back all PAD (pair with the PAD-masked loss).  With neutral tensors
    (all active, zero bias, nominal t) the outputs are bitwise the
    non-elastic ragged stages'.
    """
    if cap_slack > 0.0 and exchange != "ragged":
        raise ValueError("cap_slack > 0 needs exchange='ragged' (the padded "
                         "all_to_all requires equal m/n groups)")
    cap = dispatch_cap(m, n, cap_slack)
    if elastic:
        if exchange != "ragged":
            raise ValueError("elastic stages need exchange='ragged' (a dead "
                             "worker breaks the padded equal-groups "
                             "all_to_all)")
        if not 0 <= max_failures < n:
            raise ValueError(f"max_failures {max_failures} outside [0, {n})")
        # survivors of the worst planned loss must absorb every sample
        cap = max(cap, -(-m // (n - max_failures)))
        budget = m // n if cap == m // n else exchange_budget(cap, m)
        out_rows = m if cap == m // n else n * budget
    else:
        budget = m // n if cap_slack <= 0.0 else exchange_budget(cap, m)
        out_rows = m if cap_slack <= 0.0 else n * budget
    if get_codec(codec) is not None and exchange != "ragged":
        raise ValueError("codec exchange needs exchange='ragged'")
    if exchange == "ragged":
        route = make_esd_exchange(exchange, n, m, budget=budget,
                                  out_rows=out_rows, codec=codec)
    else:
        route = make_esd_exchange(exchange, n, m)

    def split(a):
        return a.reshape((n, m) + a.shape[1:])

    def ids(sparse):
        """The batch's ids per worker, PS-linearized under ``part``."""
        s = split(sparse)
        return part.to_linear(s) if part is not None else s

    def flat(x):
        return x.reshape((n * out_rows,) + x.shape[2:])

    def decide(esd_state, sparse):
        assign, alg1 = esd_decide(ids(sparse), esd_state, t_tran, alpha,
                                  cap_slack=cap_slack, with_cost=True,
                                  part=part)
        return assign.reshape(-1), alg1.sum()

    def exchange_update(esd_state, sparse, dense, labels, assign,
                        staged=None):
        tr = get_tracer()
        with tr.span("advance.exchange"):
            (s2, d2, l2), overflow = route(
                (ids(sparse), split(dense), split(labels)), split(assign))
        with tr.span("advance.cache"):
            if sparse_esd:
                new_state, counts = esd_state_update_sparse(
                    esd_state, need_ids_list(s2), capacity, part,
                    staged=staged)
            else:
                new_state, counts = esd_state_update(
                    esd_state, need_matrix(s2, esd_state.latest.shape[1]),
                    capacity, staged=staged)
        counts = dict(counts)
        counts["exchange_overflow"] = overflow
        return (flat(s2), flat(d2), flat(l2)), new_state, counts

    def realized(esd_state, sparse, assign, t, col_bias=None):
        C, _ = esd_cost_matrices(ids(sparse), esd_state, t, col_bias,
                                 part=part)
        got = torch.gather(C, 2, split(assign).long()[:, :, None])[:, :, 0]
        total = torch.zeros((), dtype=torch.float32, device=sparse.device)
        for i in range(n):       # a worker at a time, in order: the same bits
            total = total + got[i].sum()
        return total

    def realized_cost(esd_state, sparse, assign):
        return realized(esd_state, sparse, assign, t_tran)

    if not elastic:
        return decide, exchange_update, realized_cost, out_rows

    # -- elastic variants: per-step churn tensors, fixed shapes ------------
    def decide_e(esd_state, sparse, t_arr, col_bias, active):
        state = mask_state(esd_state, active)
        assign, alg1 = esd_decide(ids(sparse), state, t_arr, alpha,
                                  cap_slack=cap_slack, with_cost=True,
                                  col_bias=col_bias, cap=cap, part=part)
        return assign.reshape(-1), alg1.sum()

    def advance_e(esd_state, sparse, dense, labels, assign, active):
        # mask BEFORE the update: a dead worker's stale planes must not
        # survive into the committed state (its rejoin is cold)
        return exchange_update(mask_state(esd_state, active), sparse, dense,
                               labels, assign)

    def realized_cost_e(esd_state, sparse, assign, t_arr, col_bias, active):
        return realized(mask_state(esd_state, active), sparse, assign,
                        t_arr, col_bias)

    return decide_e, advance_e, realized_cost_e, out_rows


def make_dlrm_repair_stage(n: int, m: int, t_tran: torch.Tensor, *,
                           part=None, cap_slack: float = 0.0):
    """Commit-time repair for the decide-ahead chain (reference
    ``make_dlrm_repair_stage``), per worker:

      repair(committed_state, decide_state, sparse, assign)
          -> (assign' (k,), n_reassigned)

    Flags the samples whose ids' ``latest`` or ``dirty`` columns changed
    between the decide-time state and the committed one
    (:func:`changed_samples_mask`) and re-places only those with the
    capped greedy (:func:`esd_reassign`) against the committed state's
    cost matrix; every other sample keeps its stale worker.  With
    ``part`` the ids are PS-linearized first and the cost priced per
    shard.  ``n_reassigned`` is the flagged count over all workers
    (0-dim int32).
    """
    cap = dispatch_cap(m, n, cap_slack)

    def repair(committed_state, decide_state, sparse, assign):
        s = sparse.reshape((n, m) + sparse.shape[1:])
        if part is not None:
            s = part.to_linear(s)
        flagged = changed_samples_mask(s, decide_state, committed_state)
        C, _ = esd_cost_matrices(s, committed_state, t_tran, part=part)
        a2, n_re = esd_reassign(C, assign.reshape(n, m), flagged, cap)
        return a2.reshape(-1), n_re

    return repair


# --------------------------------------------------------------------------
# shapes on the meta device (the dry run)
# --------------------------------------------------------------------------
META = torch.device("meta")


def param_shapes(cfg: ModelConfig):
    """``cfg``'s model on the ``meta`` device: every parameter's shape and
    dtype, no memory (the reference's ``ShapeDtypeStruct`` tree, one
    module a layer)."""
    return api.init_model(cfg, generator=None, device=META)


def opt_state_shapes(cfg: ModelConfig, optimizer, model=None):
    """``optimizer``'s state for ``model`` (``param_shapes(cfg)`` when
    None), on ``meta``."""
    model = param_shapes(cfg) if model is None else model
    return optimizer.init(list(model.parameters()))


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Every model input of a train or prefill batch, on ``meta``, with
    the reference's dtypes: int32 tokens and labels, bf16 frames and
    patches."""
    B, S = shape.global_batch, shape.seq_len

    def t(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=META)

    if cfg.family == "audio":
        dec = min(S, whisper.DEC_CTX)
        return {"frames": t((B, S, cfg.d_model), torch.bfloat16),
                "tokens": t((B, dec)), "labels": t((B, dec))}
    if cfg.family == "vlm":
        return {"tokens": t((B, S - cfg.n_patches)),
                "labels": t((B, S - cfg.n_patches)),
                "patches": t((B, cfg.n_patches, cfg.d_model),
                             torch.bfloat16)}
    return {"tokens": t((B, S)), "labels": t((B, S))}


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of ``shape.global_batch`` x ``shape.seq_len``, on
    ``meta``."""
    return api.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                 META)


def decode_input_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """(token (B, 1) int32, pos () int32) on ``meta``; the port's decode
    step takes ``pos`` as a host int."""
    return (torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device=META),
            torch.empty((), dtype=torch.int32, device=META))


def input_specs(arch_cfg: ModelConfig, shape_name: str,
                optimizer_name: str = "adam") -> dict:
    """Everything the dry run needs for one (arch, shape): ``shape``,
    ``optimizer`` (lr 1e-3), ``params`` (the meta model), and by the
    shape's kind ``opt_state`` and ``batch`` (train), ``batch``
    (prefill), or ``cache``, ``token`` and ``pos`` (decode)."""
    shape = INPUT_SHAPES[shape_name]
    opt = get_optimizer(optimizer_name, 1e-3)
    out = {"shape": shape, "optimizer": opt,
           "params": param_shapes(arch_cfg)}
    if shape.kind == "train":
        out["opt_state"] = opt_state_shapes(arch_cfg, opt, out["params"])
        out["batch"] = batch_shapes(arch_cfg, shape)
    elif shape.kind == "prefill":
        out["batch"] = batch_shapes(arch_cfg, shape)
    else:
        out["cache"] = cache_shapes(arch_cfg, shape)
        out["token"], out["pos"] = decode_input_shapes(arch_cfg, shape)
    return out
