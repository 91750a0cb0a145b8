"""Training driver on PyTorch (CUDA by default): the DLRM ESD step, and
next-token training of the dense LMs.

The counterpart of the JAX package's ``launch/train.py``.  DLRM mode:
``--workers`` edge workers share one device, the worker being a
leading tensor dimension.  A seeded Zipf CTR stream (``--seed`` + 1)
feeds, with ``--esd-alpha``, three stages per step
(:func:`repro_torch.launch.steps.make_dlrm_esd_stages`, driven by
:class:`repro_torch.pipeline.runner.PipelinedRunner`):

  decide   Alg. 1 over each worker's touched ids, through the
           pooled-lookup kernel, then Alg. 2 (auction + greedy);
  advance  the sample exchange (``--exchange ragged``: every worker's
           ids, dense features and labels packed in one launch of the
           pack kernel) and the sparse cache-state update;
  train    the DLRM forward and backward on the exchanged batch, then
           row-wise Adagrad.

Pipelining (the paper's decision hiding, Fig. 3): ``--pipeline-depth
d`` lets decide and advance run up to d - 1 steps ahead of train, and
gives the synchronous run's values at any depth.  On a card at d >= 2
the decide/advance chain runs on a CUDA stream of its own
(:mod:`repro_torch.pipeline.streams`), so its host work (the auction's
greedy, the batch uploads) overlaps the device's training.
``--stale-decide`` decides on the state one step older (double-
buffered) and records the commit-time re-score ``alg1_realized``;
``--decide-ahead A`` keeps up to A + 1 decisions buffered on
progressively stale states and repairs each at commit (re-placing the
samples whose ids changed state: ``n_reassigned``).  ``--lookahead W``
slides a W-batch window over the stream (``window_dedup_frac``), and
``--prefetch B`` (with ``--lookahead``) stages up to B of the window's
future-miss rows a step into a plane of ``--prefetch-slots`` rows
through the staged-gather kernel, on the train stream at its place in
host order; the misses then split into ``prefetch_bytes``,
``demand_miss_bytes`` and ``prefetch_hit_rate``.

``--codec`` (fp16, int8, int4, ``int8:64`` …) turns on the quantized
wire: the exchange sends the dense features quantized (the fused
gather-quantize kernel), the train stage computes on the tables as the
wire delivers them (straight-through estimator) and pushes each table's
gradient through the codec with error feedback, Alg. 1 prices every
link at the codec's bytes (``--codec-policy bandwidth``: fp16 on the
links at or above the median bandwidth, the codec below it), and the
prefetch pull stages the rows as the wire delivers them.

Without ``--esd-alpha`` each step trains the batch as it comes.  Every
step logs the loss, its wall time and, with ESD, the cache counts and
their transmission cost.  The summary adds ``wall_ms_mean`` (the mean
wall time a step after the first ``d`` steps) and each stage's mean
milliseconds over the steps after the first (which builds the kernels
and warms the allocator): at depth 1, or on the CPU, host time up to a
device synchronise; at depth >= 2 on a card, device time between CUDA
events on the stage's stream (the host's unsynchronised issue time in
``host_ms_mean``; ``step_ms_mean`` is then null, as the stages
overlap).  Model weights are random, drawn from ``--seed``.

LM mode (any ``--arch`` that is not a DLRM config; ``--smoke`` takes
the reduced variant): ``--batch-per-worker`` sequences of ``--seq-len``
tokens on the one device, drawn from a seeded Zipf token stream
(``--seed``, inputs ``[:, :-1]``, labels ``[:, 1:]``), trained by Adam
through :func:`repro_torch.launch.steps.make_train_step`.  At
``--seq-len`` 2048 and above (a multiple of 512) every layer's attention
runs through the flash kernel B8.  Only the dense families run; the
rest raise (ROADMAP A14).  Every step logs the loss and its wall time
after a synchronise.

Flags of the reference that this port does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-s1 \\
      --workers 4 --batch-per-worker 256 --steps 20 --esd-alpha 1 \\
      --exchange ragged --capacity-ratio 0.2 --pipeline-depth 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-s1 \\
      --workers 4 --batch-per-worker 256 --steps 20 --esd-alpha 1 \\
      --exchange ragged --pipeline-depth 4 --lookahead 4 \\
      --decide-ahead 3 --prefetch 64 --prefetch-slots 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 3 --esd-alpha 1 \\
      --exchange ragged --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 6 --esd-alpha 1 \\
      --exchange ragged --pipeline-depth 4 --lookahead 4 \\
      --decide-ahead 3 --prefetch 16 --prefetch-slots 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 3 --esd-alpha 1 \\
      --exchange ragged --codec int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --seq-len 2048 --batch-per-worker 4 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --seq-len 2048 --batch-per-worker 1 --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..configs import DLRM_CONFIGS, get_config
from ..core.cost import transmission_time_codec
from ..core.dispatch import esd_sparse_init
from ..core.simulator import DEFAULT_BANDWIDTHS
from ..data.loader import PrefetchLoader
from ..data.synthetic import WORKLOADS, token_stream
from ..models import api
from ..models.dlrm import bce_loss, bce_loss_masked, init_params
from ..obs import MetricsRegistry, log_step
from ..optim import get_optimizer
from ..pipeline.prefetch import (PrefetchPlane, prefetch_candidates,
                                 prefetch_init, prefetch_pull,
                                 prefetch_select, staged_membership)
from ..pipeline.runner import PipelinedRunner
from ..pipeline.streams import ChainStreams
from ..pipeline.window import LookaheadWindow
from ..quant.codecs import (codec_name, get_codec, quantize_with_feedback,
                            resolve_link_codecs, row_wire_bytes, ste)
from ..device import resolve_device
from .steps import (make_dlrm_esd_stages, make_dlrm_repair_stage,
                    raise_on_overflow)
from .steps import make_train_step as make_lm_train_step

__all__ = ["build_parser", "make_train_step", "run_dlrm", "run_lm", "main"]


def _unported(args) -> None:
    """Raise on every flag of the reference this slice does not carry."""
    todo = [
        (args.fault_plan is not None, "--fault-plan", "A10"),
        (args.ckpt_dir is not None, "--ckpt-dir", "A10"),
        (args.resume, "--resume", "A10"),
        (args.ckpt_every != 50, "--ckpt-every", "A10"),
        (args.compute_time_s != 0.010, "--compute-time-s", "A10"),
        (args.n_ps > 1, "--n-ps > 1", "A2"),
        (args.ps_hetero, "--ps-hetero", "A2"),
        (args.ps_layout != "contiguous", "--ps-layout", "A2"),
        (args.esd_engine == "dense", "--esd-engine dense", "A4"),
        (args.trace_out is not None, "--trace-out", "A15"),
        (args.validate_timing, "--validate-timing", "A15"),
        (args.trace_buffer != 65536, "--trace-buffer", "A15"),
        (args.smoke, "--smoke", "A14"),
        (args.seq_len != 64, "--seq-len", "A14"),
    ]
    _raise_unported(todo)


def _raise_unported(todo) -> None:
    for hit, flag, item in todo:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet (ROADMAP {item})")


def make_train_step(model, loss_fn, optimizer, codec=None):
    """The train stage: ``step(sparse, dense, labels) -> loss`` runs the
    forward and backward of ``loss_fn`` and applies ``optimizer`` to the
    model's parameters, copying the new values in place.

    With a ``codec`` it is the quantized PS push and pull (the
    reference's ``train_jit_q``): the loss runs on the model with its
    tables (``embed``, and ``wide`` for wdl) passed through :func:`ste`,
    the rows as the wire delivers them with the gradient straight
    through; each table's gradient goes up through
    :func:`quantize_with_feedback`, its residual carried from step to
    step (zeros at the start), and the optimizer sees the pushed
    ``g_hat``.  ``codec=None`` is the fp32 step, unchanged."""
    model.requires_grad_(True)
    names = [name for name, _ in model.named_parameters()]
    params = list(model.parameters())
    opt_state = optimizer.init(params)
    codec = get_codec(codec)
    tables = ([i for i, name in enumerate(names) if name in ("embed", "wide")]
              if codec is not None else [])
    residual = {i: torch.zeros_like(params[i]) for i in tables}

    def loss_of(sparse, dense, labels):
        if not tables:
            return loss_fn(model, sparse, dense, labels)
        down = {names[i]: ste(params[i], codec) for i in tables}
        return loss_fn(lambda *a: torch.func.functional_call(model, down, a),
                       sparse, dense, labels)

    def step(sparse, dense, labels):
        nonlocal opt_state
        loss = loss_of(sparse, dense, labels)
        grads = list(torch.autograd.grad(loss, params))
        for i in tables:
            grads[i], residual[i] = quantize_with_feedback(
                grads[i], residual[i], codec)
        new, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        return loss.detach()

    return step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pipeline_guards(args, use_esd: bool) -> bool:
    """The reference's guards on the pipelining flags; returns whether
    the prefetch plane is on."""
    if args.stale_decide and args.pipeline_depth < 2:
        raise SystemExit("--stale-decide needs --pipeline-depth >= 2")
    if (args.pipeline_depth > 1 or args.stale_decide) and not use_esd:
        raise SystemExit("--pipeline-depth > 1 / --stale-decide need ESD "
                         "(--esd-alpha): without dispatch there is no "
                         "decision stage to pipeline")
    if args.decide_ahead:
        if not use_esd:
            raise SystemExit("--decide-ahead needs ESD (--esd-alpha): the "
                             "chain buffers dispatch decisions")
        if args.stale_decide:
            raise SystemExit("--decide-ahead subsumes --stale-decide (the "
                             "chain decides on progressively stale states "
                             "already); pick one")
    use_prefetch = args.prefetch > 0
    if use_prefetch:
        if not use_esd:
            raise SystemExit("--prefetch needs ESD (--esd-alpha): the split "
                             "miss accounting lives in the cache update)")
        if args.lookahead <= 0:
            raise SystemExit("--prefetch needs --lookahead > 0 (the window "
                             "meta is what names the future misses)")
        if args.prefetch_slots < args.prefetch:
            raise SystemExit("--prefetch-slots must be >= --prefetch (one "
                             "step's pulls must fit the plane)")
    return use_prefetch


def run_dlrm(args, model=None) -> dict:
    """Train ``args.steps`` steps; returns the summary: the per-step
    records (``metrics``), the mean stage times, the mean wall time a
    step, and the final cache state and prefetch plane.  ``model``
    replaces the seeded random weights (tests pass the JAX package's)."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _unported(args)
    cfg = DLRM_CONFIGS[args.arch]
    wl = WORKLOADS[cfg.workload]
    n = args.workers
    m = args.batch_per_worker
    k = m * n
    V = wl.vocab
    depth = args.pipeline_depth
    use_esd = args.esd_alpha is not None
    capacity = int(args.capacity_ratio * V)
    capacity = capacity if capacity < V else None     # None: no LRU cut
    if args.cap_slack > 0.0:
        if not use_esd:
            raise SystemExit("--cap-slack needs ESD (--esd-alpha)")
        if args.exchange != "ragged":
            raise SystemExit("--cap-slack > 0 needs --exchange ragged (the "
                             "padded all_to_all requires equal m/n groups)")
    use_prefetch = _pipeline_guards(args, use_esd)
    codec = get_codec(args.codec)
    if codec is not None and use_esd and args.exchange != "ragged":
        raise SystemExit("--codec with ESD needs --exchange ragged (the "
                         "quantized sample wire rides the ragged executor)")
    if args.codec_policy != "uniform" and codec is None:
        raise SystemExit("--codec-policy bandwidth needs --codec (it picks "
                         "which codec the slow links drop to)")

    # each link's row time at its codec's payload + metadata bytes (no
    # codec: 4 bytes an element)
    bw = DEFAULT_BANDWIDTHS(n)
    link_codecs = resolve_link_codecs(args.codec_policy, bw, codec)
    t_tran = torch.tensor(
        transmission_time_codec(cfg.embedding_dim, bw, link_codecs),
        dtype=torch.float32, device=device)
    t_np = t_tran.cpu().numpy()
    wire = row_wire_bytes(cfg.embedding_dim, codec)   # row bytes on the wire
    optimizer = get_optimizer("rowwise_adagrad", args.lr)
    if model is None:
        model = init_params(cfg, wl, torch.Generator(device=device)
                            .manual_seed(args.seed), device)
    # PAD-masked loss only when PAD rows can appear (capacity slack)
    step = make_train_step(
        model, bce_loss_masked if args.cap_slack > 0.0 else bce_loss,
        optimizer, codec)
    # depth >= 2 on a card: the decide/advance chain on its own stream
    streams = ChainStreams(device, enabled=use_esd and depth > 1)

    reg = MetricsRegistry()
    stage_h = {s: reg.histogram(f"train.{s}_s", keep=True)
               for s in ("decide", "advance", "train")}
    spans = {s: [] for s in stage_h}      # CUDA event pairs when pipelined

    def timed(stage, fn):
        """Synchronous clock: host time up to a device synchronise.  With
        the chain streams: CUDA events on the stage's stream (device
        time, read at the end) and the host's issue time, unsynced."""
        def run(*a):
            t0 = time.perf_counter()
            start = streams.mark(timing=True)
            out = fn(*a)
            if streams.enabled:
                spans[stage].append((start, streams.mark(timing=True)))
            else:
                _sync(device)
            stage_h[stage].observe(time.perf_counter() - t0)
            return out
        return run

    train_step = timed("train", lambda x: step(*x))

    last_t = time.perf_counter()
    walls = []

    def record(i, loss, counts, meta, info, pulled=None):
        nonlocal last_t
        # the step ends when its loss is on the host (pipelined, that
        # wait comes here)
        loss = float(loss)
        now = time.perf_counter()
        walls.append(now - last_t)
        rec = {"loss": loss, "wall_s": round(now - last_t, 4)}
        last_t = now
        if counts is not None:
            # loud failure on silent row loss
            raise_on_overflow(counts)
            base_ops = ("miss_pull", "update_push", "evict_push")
            ops = {op: counts[op].cpu().numpy() for op in base_ops}
            rec["cost"] = float(sum((ops[o] * t_np).sum() for o in ops))
            rec.update({op: int(v.sum()) for op, v in ops.items()})
            # the miss split: with the staging plane on, a miss whose row
            # was staged left the critical path (prefetch off: every
            # miss is a demand miss)
            hit = (int(counts["prefetch_hit"].sum())
                   if "prefetch_hit" in counts else 0)
            demand = (int(counts["demand_miss"].sum())
                      if "demand_miss" in counts
                      else int(ops["miss_pull"].sum()))
            rec["prefetch_bytes"] = (int(pulled) * wire
                                     if pulled is not None else 0)
            rec["demand_miss_bytes"] = demand * wire
            rec["prefetch_hit_rate"] = round(hit / max(hit + demand, 1), 4)
        if meta is not None:
            rec["window_dedup_frac"] = round(meta.dedup_frac, 4)
        for key in ("alg1_est", "alg1_realized"):
            if key in info:
                rec[key] = float(info[key])
        if "n_reassigned" in info:
            rec["n_reassigned"] = int(info["n_reassigned"])
        rec = reg.record_step(i, rec)
        if args.verbose and (i % args.log_every == 0 or i == args.steps - 1):
            log_step(rec)
        return rec

    # the host batch stream, with the lookahead window's dedup meta
    host = wl.stream(args.seed + 1, k)
    src = (LookaheadWindow(host, args.lookahead, key=lambda b: b[0])
           if args.lookahead > 0 else ((b, None) for b in host))

    def device_batches():
        for (sparse, dense, labels), meta in src:
            with streams.chain():         # an upload waits for its stream
                batch = (torch.as_tensor(sparse.astype(np.int32),
                                         device=device),
                         torch.as_tensor(dense, device=device),
                         torch.as_tensor(labels, device=device))
            yield batch, meta

    esd = pf_plane = None
    if not use_esd:
        batches = device_batches()
        for i in range(args.steps):
            batch, meta = next(batches)
            record(i, train_step(batch), None, meta, {})
    else:
        decide, advance, realized, out_rows = make_dlrm_esd_stages(
            n, m, t_tran, args.esd_alpha, exchange=args.exchange,
            cap_slack=args.cap_slack, capacity=capacity, codec=codec)
        with streams.chain():
            # L = out_rows * W ids per worker after the exchange
            esd = esd_sparse_init(n, V, capacity,
                                  max_ids=out_rows * wl.width, device=device)
            if use_prefetch:
                pf_plane = prefetch_init(args.prefetch_slots,
                                         cfg.embedding_dim, device)
        pf_cands = max(8 * args.prefetch, 256)
        dec_step, adv_step = itertools.count(), itertools.count()
        pull_done = None      # event after the latest prefetch pull

        def on_chain(fn):
            def run(*a):
                with streams.chain():
                    return fn(*a)
            return run

        def with_staged(state, memb):
            # price the staging plane into Alg. 1: a staged row pulls for
            # free, so the decision sees it as a resident latest copy (the
            # committed cache state never includes it)
            return dataclasses.replace(state,
                                       latest=state.latest | memb[None, :])

        @on_chain
        @partial(timed, "decide")
        def decide_fn(state, batch):
            i = next(dec_step)
            if use_prefetch:
                streams.wait(pull_done)
                state = with_staged(state, staged_membership(pf_plane, V, i))
            assign, alg1 = decide(state, batch[0][0])
            return assign, streams.to_host(alg1)

        def pull(sel):
            """The prefetch pull reads the table train updates in place:
            on the train stream at its place in host order, after the
            trains issued so far and before the next."""
            nonlocal pf_plane, pull_done
            selected = streams.mark()
            with streams.trainer():
                streams.wait(selected)
                streams.give((sel.src, sel.sel_ids, sel.sel_slot,
                              sel.sel_ok))
                rows = prefetch_pull(pf_plane.rows, model.embed.detach(), sel,
                                     codec)
                pull_done = streams.mark()
            pf_plane = PrefetchPlane(ids=sel.ids, rows=rows,
                                     expiry=sel.expiry)

        @on_chain
        @partial(timed, "advance")
        def advance_fn(state, batch, assign):
            (s, d, l), meta = batch
            i = next(adv_step)
            aux = {"meta": meta}
            if use_prefetch:
                # split this step's misses against the plane as staged by
                # steps < i, then pull rows for the window's future misses
                memb = staged_membership(pf_plane, V, i)
                x, new_state, counts = advance(state, s, d, l, assign, memb)
                cids, cexp = prefetch_candidates(meta, i, pf_cands)
                sel = prefetch_select(
                    pf_plane, new_state.latest.any(dim=0),
                    torch.as_tensor(cids, device=device),
                    torch.as_tensor(cexp, device=device), i,
                    budget=args.prefetch)
                aux["prefetch_pulled"] = streams.to_host(sel.n_pulled)
                pull(sel)
            else:
                x, new_state, counts = advance(state, s, d, l, assign)
            aux["counts"] = {key: streams.to_host(v)
                             for key, v in counts.items()}
            # the step's chain work and host copies are done at this event
            aux["ready"] = streams.mark()
            return (x, aux["ready"]), new_state, aux

        def train_fn(x):
            x, ready = x
            streams.wait(ready)
            streams.give(x)
            return streams.host_value(train_step(x))

        realized_fn = repair_fn = None
        if args.stale_decide or args.decide_ahead:
            @on_chain
            def realized_fn(state, batch, assign):
                return streams.to_host(realized(state, batch[0][0], assign))
        if args.decide_ahead:
            repair = make_dlrm_repair_stage(n, m, t_tran,
                                            cap_slack=args.cap_slack)

            @on_chain
            def repair_fn(committed, decided, batch, assign):
                a2, n_re = repair(committed, decided, batch[0][0], assign)
                return a2, {"n_reassigned": streams.to_host(n_re)}

        def record_fn(t, loss, aux, info):
            if aux["ready"] is not None:
                aux["ready"].synchronize()
            return record(t, loss, aux["counts"], aux["meta"], info,
                          aux.get("prefetch_pulled"))

        runner = PipelinedRunner(
            decide_fn, advance_fn, train_fn, esd, depth=depth,
            stale=args.stale_decide, realized_cost_fn=realized_fn,
            decide_ahead=args.decide_ahead, repair_fn=repair_fn)
        runner.run(device_batches(), steps=args.steps, record_fn=record_fn)
        esd = runner.esd_state
        streams.finish()

    def mean_ms(xs):
        xs = xs[1:] if len(xs) > 1 else xs
        return float(np.mean(xs)) * 1e3 if xs else None

    host_ms = {s: mean_ms(h.samples) for s, h in stage_h.items()}
    if streams.enabled:
        # device time of each stage on its own stream; a step is only
        # its wall time, the stages overlap
        _sync(device)
        stage_s = {s: [a.elapsed_time(b) * 1e-3 for a, b in pairs]
                   for s, pairs in spans.items()}
        stages = {s: mean_ms(xs) for s, xs in stage_s.items()}
        step_ms = None
    else:
        stage_s = {s: list(h.samples) for s, h in stage_h.items()}
        stages = host_ms
        step_ms = sum(v for v in stages.values() if v is not None)
    wall_ms = (float(np.mean(walls[depth:])) * 1e3
               if len(walls) > depth else None)
    per_step_ms = step_ms or wall_ms
    return {"metrics": reg.steps, "device": str(device), "workers": n,
            "batch": k, "steps": len(reg.steps), "codec": codec_name(codec),
            "pipeline_depth": depth,
            "stage_clock": "device" if streams.enabled else "host",
            "decide_ms_mean": stages["decide"],
            "advance_ms_mean": stages["advance"],
            "train_ms_mean": stages["train"], "step_ms_mean": step_ms,
            "wall_ms_mean": wall_ms,
            "host_ms_mean": host_ms if streams.enabled else None,
            "stage_s": stage_s,
            "samples_per_s": k / (per_step_ms * 1e-3) if per_step_ms
            else None,
            "esd_state": esd, "prefetch_plane": pf_plane}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=4,
                    help="edge workers, sharing one device (the "
                         "reference takes one device per worker)")
    ap.add_argument("--batch-per-worker", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (CPU-sized) arch variant")
    ap.add_argument("--esd-alpha", type=float, default=None,
                    help="enable ESD dispatch with this HybridDis alpha")
    ap.add_argument("--esd-engine", choices=("sparse", "dense"),
                    default="sparse")
    ap.add_argument("--exchange", choices=("padded", "ragged"),
                    default="padded",
                    help="sample wire path: fixed m/n all_to_all (padded) "
                         "or the budgeted executor (ragged)")
    ap.add_argument("--cap-slack", type=float, default=0.0,
                    help="relax the per-worker dispatch capacity by this "
                         "fraction of m/n (needs --exchange ragged)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="decide/advance may run this many steps ahead of "
                         "training, on a stream of their own on a card "
                         "(1 = synchronous; every depth gives its values)")
    ap.add_argument("--lookahead", type=int, default=0,
                    help="W-batch dedup window over the input stream; "
                         "logs window_dedup_frac")
    ap.add_argument("--decide-ahead", type=int, default=0,
                    help="buffer up to this many + 1 decisions on "
                         "progressively stale states, each repaired at "
                         "commit (n_reassigned, alg1_realized)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="stage up to this many of the window's future-miss "
                         "rows a step into the staging plane (needs "
                         "--lookahead > 0; 0 = off)")
    ap.add_argument("--prefetch-slots", type=int, default=512,
                    help="staging-plane capacity in rows")
    ap.add_argument("--stale-decide", action="store_true",
                    help="decide on the state one step older "
                         "(double-buffered); logs the commit-time re-score "
                         "alg1_realized (needs --pipeline-depth >= 2)")
    ap.add_argument("--capacity-ratio", type=float, default=0.2)
    ap.add_argument("--n-ps", type=int, default=1)
    ap.add_argument("--ps-layout", choices=("contiguous", "hashed"),
                    default="contiguous")
    ap.add_argument("--ps-hetero", action="store_true")
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--compute-time-s", type=float, default=0.010)
    ap.add_argument("--codec", default=None,
                    help="wire codec for embedding traffic: none (exact "
                         "fp32), fp16, int8, int4, or KIND:BLOCK for "
                         "per-block scale groups")
    ap.add_argument("--codec-policy", choices=("uniform", "bandwidth"),
                    default="uniform",
                    help="uniform: every link uses --codec; bandwidth: "
                         "links at or above the median get fp16, slower "
                         "links get --codec (priced into Alg. 1)")
    ap.add_argument("--ckpt-dir", type=Path, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--verbose", action="store_true", default=True)
    ap.add_argument("--trace-out", type=Path, default=None)
    ap.add_argument("--trace-buffer", type=int, default=65536)
    ap.add_argument("--validate-timing", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def run_lm(args, model=None, cfg=None) -> dict:
    """Next-token training of a dense LM for ``args.steps`` steps; returns
    the summary: the per-step records (``metrics``: loss, wall_s), the
    mean ms per step and tokens per second over the steps after the
    first (which builds the kernel and warms the allocator).  ``model``
    replaces the seeded random weights (tests pass the JAX package's),
    ``cfg`` the config of ``--arch`` (a variant of it, such as another
    dtype)."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _raise_unported([(args.ckpt_dir is not None, "--ckpt-dir", "A10"),
                     (args.resume, "--resume", "A10"),
                     (args.trace_out is not None, "--trace-out", "A15"),
                     (args.validate_timing, "--validate-timing", "A15")])
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"--arch {args.arch}: the {cfg.family} family is not ported to "
            f"repro_torch yet (ROADMAP A14)")
    if model is None:
        model = api.init_model(cfg, generator=torch.Generator(
            device=device).manual_seed(args.seed), device=device)
    step = make_lm_train_step(cfg, model, get_optimizer("adam", args.lr))
    B, S = args.batch_per_worker, args.seq_len
    stream = PrefetchLoader(token_stream(args.seed, cfg.vocab, B, S + 1),
                            depth=2)
    reg = MetricsRegistry()
    for i in range(args.steps):
        tok = next(stream)
        t0 = time.perf_counter()
        tok = torch.as_tensor(tok, device=device)
        loss = float(step({"tokens": tok[:, :-1], "labels": tok[:, 1:]}))
        rec = reg.record_step(i, {"loss": loss,
                                  "wall_s": time.perf_counter() - t0})
        if args.verbose and (i % args.log_every == 0 or i == args.steps - 1):
            log_step(rec)
    walls = [r["wall_s"] for r in reg.steps]
    walls = walls[1:] or walls
    step_ms = float(np.mean(walls)) * 1e3 if walls else None
    return {"metrics": reg.steps, "device": str(device), "arch": cfg.name,
            "batch": B, "seq_len": S, "steps": len(reg.steps),
            "step_ms_mean": step_ms,
            "tokens_per_s": B * S / (step_ms * 1e-3) if step_ms else None}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.arch not in DLRM_CONFIGS:
        return run_lm(args)
    return run_dlrm(args)


if __name__ == "__main__":
    main()
