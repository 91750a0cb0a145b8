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
runs through the flash kernel B8 (full attention at hd 32, 64 or 128;
the local and chunked masks and other head widths take the reference's
blockwise scan).  The dense, MoE, SSM and hybrid families run (an MoE
layer adds the router's load-balance loss at weight 0.01; every
``mamba`` and ``rglru`` layer runs its recurrence through the
linear-scan kernel, forward and backward).  The driver feeds tokens
only, as the reference's does, so it refuses the VLM and audio families
with a ``SystemExit``: they train through
:func:`repro_torch.launch.steps.make_train_step` over
:func:`repro_torch.models.api.make_train_batch`'s batches.  Every step
logs the loss and its wall time after a synchronise.

Multi-PS (the paper's "one or more parameter servers"): ``--n-ps P``
partitions the vocabulary over P servers (``--ps-layout contiguous``
row ranges, or ``hashed``, id mod P), the tables are PS-stacked
((P, max_rows, E), :func:`repro_torch.models.dlrm.ps_stack_tables`),
ids, the exchanged samples and the cache planes live in the
PS-linearized space, and every link time is per (worker, PS): the
defaults repeated, or with ``--ps-hetero`` the last PS behind 0.5 Gbps
links (:func:`repro_torch.core.simulator.hetero_ps_bandwidths`).
Alg. 1 prices a miss or a push at the owning shard's link through the
pooled-lookup kernel, and a record's ``cost`` sums the per-(worker, PS)
counts times their link times.  ``--esd-engine dense`` keeps the cache
state as dense (n, V) planes (:class:`repro_torch.core.dispatch.
EsdState`): every id every step, the same counts as the sparse engine.
As in the reference, the dense engine and the prefetch plane refuse
``--n-ps > 1``, and ``--ps-hetero`` needs it.

Elastic operation: ``--fault-plan`` (the DSL of
:meth:`repro_torch.elastic.FaultPlan.parse`, or ``@plan.json``; needs
ESD and ``--exchange ragged``) runs the elastic stages.  Each step's
effective link times (bandwidth droop), cost-column bias (a straggler's
excess compute at ``--compute-time-s`` a step; a dead worker's finite
penalty) and membership mask come from the plan, computed on the host
and uploaded once before the run; a dead worker's cache state is masked
before decide and before the update, the capacity is raised so the
survivors absorb every sample (``ceil(m / (n - max_failures))``), the
loss is the PAD-masked one, and every record carries ``n_active``; a
``ps_outage`` event slows one shard's links (``--n-ps > 1``).
Checkpoints: ``--ckpt-dir`` and ``--ckpt-every`` write the reference's
npz layout (:mod:`repro_torch.checkpoint`: ``params``, ``opt``, the
post-advance cache state ``esd`` and the codec's residual ``qres``; the
LM ``params`` and ``opt``) after a step's train and before the next
step's, so at depth >= 2 a checkpoint holds the step it names;
``--resume`` restores the newest and skips the stream's first batches
to match.  As in the reference, ``--decide-ahead`` and ``--prefetch``
refuse a fault plan.

Tracing (:mod:`repro_torch.obs`): with ``--trace-out PATH`` or
``--validate-timing``, :func:`main` installs a :class:`Tracer` of
``--trace-buffer`` spans (drop-oldest) for the run.  The runner's spans
(``decide``, ``realized``, ``repair``, ``advance`` on the ``decide``
track; each step's in-flight ``train`` window and its ``train.sync`` on
``train/<t % depth>``), the prefetch pull's ``prefetch.pull`` (track
``prefetch``), the LM step's ``train.sync`` (``train/0``), the loader's
``data.load`` and the checkpoints' ``checkpoint.save`` and
``checkpoint.restore`` (track ``io``) are host wall time.  On a card at
depth >= 2, where the chain and train run on two streams and a host
span times only the issue, every ``decide``, ``advance`` and
``train.sync`` span also carries ``device_ms``: its step's stage time
between CUDA events on the stage's stream, read after the run's final
synchronise.  ``--trace-out`` writes the Chrome/Perfetto trace_event
JSON (open it in ui.perfetto.dev) even when the run fails;
``--validate-timing`` prints :func:`repro_torch.obs.format_report` of
:func:`repro_torch.obs.validate_timing` over the spans and the records
to stderr.  Both print the ring's dropped spans, if any, and the top-10
spans by total wall time.  A traced run's records equal an untraced
one's.  Each run installs its :class:`MetricsRegistry` process-wide
(:func:`repro_torch.obs.get_registry`): its ``steps`` is the summary's
``metrics`` list.

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
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 3 --esd-alpha 1 \\
      --exchange ragged --n-ps 3 --ps-layout hashed --ps-hetero --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 3 --esd-alpha 1 \\
      --exchange ragged --esd-engine dense --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 6 --esd-alpha 1 \\
      --exchange ragged --device cpu --ckpt-dir build/ckpt \\
      --fault-plan "straggle@1:0x4-4; crash@2:1g; rejoin@4:1w"
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --seq-len 2048 --batch-per-worker 4 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --seq-len 2048 --batch-per-worker 1 --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import (load_train_tree, restore_checkpoint,
                          save_checkpoint, train_tree)
from ..configs import DLRM_CONFIGS, get_config
from ..core.cost import transmission_time_codec
from ..core.dispatch import esd_init, esd_sparse_init
from ..core.simulator import DEFAULT_BANDWIDTHS, hetero_ps_bandwidths
from ..data.loader import PrefetchLoader
from ..data.synthetic import WORKLOADS, token_stream
from ..elastic import FaultPlan, cost_column_bias, effective_t
from ..models import api, backbone
from ..models.dlrm import (bce_loss, bce_loss_masked, init_params,
                           ps_stack_tables, ref_paths)
from ..obs import (MetricsRegistry, Tracer, format_report, get_tracer,
                   log_step, set_registry, set_tracer, validate_timing)
from ..optim import get_optimizer
from ..pipeline.prefetch import (PrefetchPlane, prefetch_candidates,
                                 prefetch_init, prefetch_pull,
                                 prefetch_select, staged_membership)
from ..pipeline.runner import PipelinedRunner
from ..pipeline.streams import ChainStreams
from ..pipeline.window import LookaheadWindow
from ..ps import make_partition
from ..quant.codecs import (codec_name, get_codec, quantize_with_feedback,
                            resolve_link_codecs, row_wire_bytes, ste)
from ..device import resolve_device
from .steps import (make_dlrm_esd_stages, make_dlrm_repair_stage,
                    raise_on_overflow)
from .steps import make_train_step as make_lm_train_step

__all__ = ["build_parser", "make_train_step", "run_dlrm", "run_lm", "main"]


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
    ``g_hat``.  ``codec=None`` is the fp32 step, unchanged.

    ``step.state`` holds what a checkpoint reads and replaces: ``"opt"``,
    the optimizer's state, and ``"qres"``, each table's residual by its
    parameter name (empty without a codec).  Spans: ``train.forward``
    (the loss), ``train.backward`` (``autograd.grad``) and
    ``train.update`` (the codec's feedback, the optimizer and the
    copy), each the host's issue of its part."""
    model.requires_grad_(True)
    names = [name for name, _ in model.named_parameters()]
    params = list(model.parameters())
    codec = get_codec(codec)
    tables = ([i for i, name in enumerate(names) if name in ("embed", "wide")]
              if codec is not None else [])
    state = {"opt": optimizer.init(params),
             "qres": {names[i]: torch.zeros_like(params[i]) for i in tables}}

    def loss_of(sparse, dense, labels):
        if not tables:
            return loss_fn(model, sparse, dense, labels)
        down = {names[i]: ste(params[i], codec) for i in tables}
        return loss_fn(lambda *a: torch.func.functional_call(model, down, a),
                       sparse, dense, labels)

    def step(sparse, dense, labels):
        tr = get_tracer()
        with tr.span("train.forward"):
            loss = loss_of(sparse, dense, labels)
        with tr.span("train.backward"):
            grads = list(torch.autograd.grad(loss, params))
        with tr.span("train.update"):
            res = state["qres"]
            for i in tables:
                grads[i], res[names[i]] = quantize_with_feedback(
                    grads[i], res[names[i]], codec)
            new, state["opt"] = optimizer.update(grads, state["opt"],
                                                 params)
            with torch.no_grad():
                for p, q in zip(params, new):
                    p.copy_(q)
        return loss.detach()

    step.state = state
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
        if args.fault_plan:
            raise SystemExit("--decide-ahead with --fault-plan is not wired "
                             "(the elastic stages feed per-step fault arrays "
                             "to an in-order decide stream)")
    use_prefetch = args.prefetch > 0
    if use_prefetch:
        if not use_esd:
            raise SystemExit("--prefetch needs ESD (--esd-alpha): the split "
                             "miss accounting lives in the cache update)")
        if args.lookahead <= 0:
            raise SystemExit("--prefetch needs --lookahead > 0 (the window "
                             "meta is what names the future misses)")
        if args.n_ps > 1:
            raise SystemExit("--prefetch with --n-ps > 1 is not wired (the "
                             "staging plane gathers from the unstacked "
                             "table)")
        if args.fault_plan:
            raise SystemExit("--prefetch with --fault-plan is not wired")
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
    tracer = get_tracer()
    # the run's spans begin here, on the tracer's clock
    traced_from = tracer.clock() - tracer.t0 if tracer.enabled else None
    cfg = DLRM_CONFIGS[args.arch]
    wl = WORKLOADS[cfg.workload]
    n = args.workers
    m = args.batch_per_worker
    k = m * n
    V = wl.vocab
    depth = args.pipeline_depth
    use_esd = args.esd_alpha is not None
    sparse_esd = args.esd_engine == "sparse"
    capacity = int(args.capacity_ratio * V)
    capacity = capacity if capacity < V else None     # None: no LRU cut
    if args.cap_slack > 0.0:
        if not use_esd:
            raise SystemExit("--cap-slack needs ESD (--esd-alpha)")
        if args.exchange != "ragged":
            raise SystemExit("--cap-slack > 0 needs --exchange ragged (the "
                             "padded all_to_all requires equal m/n groups)")
    use_prefetch = _pipeline_guards(args, use_esd)
    plan = None
    if args.fault_plan:
        if not use_esd:
            raise SystemExit("--fault-plan needs ESD (--esd-alpha): faults "
                             "act through the dispatch stages")
        if args.exchange != "ragged":
            raise SystemExit("--fault-plan needs --exchange ragged (a dead "
                             "worker breaks the padded equal-groups "
                             "all_to_all)")
        plan = FaultPlan.parse(args.fault_plan, n, args.n_ps)
    if args.resume and args.ckpt_dir is None:
        raise SystemExit("--resume needs --ckpt-dir")
    codec = get_codec(args.codec)
    if codec is not None and use_esd and args.exchange != "ragged":
        raise SystemExit("--codec with ESD needs --exchange ragged (the "
                         "quantized sample wire rides the ragged executor)")
    if args.codec_policy != "uniform" and codec is None:
        raise SystemExit("--codec-policy bandwidth needs --codec (it picks "
                         "which codec the slow links drop to)")

    # multi-PS: partition the vocabulary, run ids, planes and tables in
    # the PS-linearized space, and price each op at the owning shard's link
    part = make_partition(V, args.n_ps, args.ps_layout) if args.n_ps > 1 \
        else None
    if part is not None and use_esd and not sparse_esd:
        raise SystemExit("--n-ps > 1 requires --esd-engine sparse "
                         "(the dense engine has no per-PS accounting)")
    if args.ps_hetero and part is None:
        raise SystemExit("--ps-hetero needs --n-ps > 1 (there is no "
                         "per-shard link to skew with a single PS)")
    V_space = part.linear_size if part is not None else V

    # each link's row time at its codec's payload + metadata bytes (no
    # codec: 4 bytes an element); (n, n_ps) with several servers
    if part is not None:
        bw = (hetero_ps_bandwidths(n, part.n_ps) if args.ps_hetero
              else np.repeat(DEFAULT_BANDWIDTHS(n)[:, None], part.n_ps,
                             axis=1))
    else:
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
    if part is not None:
        # the tables re-homed onto the servers: (n_ps, max_rows, E)
        model = ps_stack_tables(model, part)
    # PAD-masked loss only when PAD rows can appear: capacity slack skews
    # batches, and under a fault plan a dead worker's exchanged block
    # comes back all PAD
    step = make_train_step(
        model, bce_loss_masked if args.cap_slack > 0.0 or plan is not None
        else bce_loss, optimizer, codec)
    # depth >= 2 on a card: the decide/advance chain on its own stream
    streams = ChainStreams(device, enabled=use_esd and depth > 1)

    # the run's registry, process-wide: get_registry().steps is the
    # summary's `metrics` list
    reg = MetricsRegistry()
    set_registry(reg)
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
            # ops x link times, per (worker, PS) with several servers
            per = "_ps" if part is not None else ""
            rec["cost"] = float(sum((counts[op + per].cpu().numpy()
                                     * t_np).sum() for op in base_ops))
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
        if plan is not None:
            rec["n_active"] = plan.state_at(i).n_active
        rec = reg.record_step(i, rec)
        if args.verbose and (i % args.log_every == 0 or i == args.steps - 1):
            log_step(rec)
        return rec

    esd = pf_plane = None
    if use_esd:
        # with a fault plan the elastic stages take three per-step tensors
        # (link times, cost bias, active mask) of fixed shape
        decide, advance, realized, out_rows = make_dlrm_esd_stages(
            n, m, t_tran, args.esd_alpha, part=part, exchange=args.exchange,
            cap_slack=args.cap_slack, sparse_esd=sparse_esd,
            capacity=capacity, codec=codec, elastic=plan is not None,
            max_failures=plan.max_inactive() if plan is not None else 0)
        with streams.chain():
            # L = out_rows * W ids per worker after the exchange
            esd = (esd_sparse_init(n, V_space, capacity,
                                   max_ids=out_rows * wl.width, device=device)
                   if sparse_esd else esd_init(n, V, device))
            if use_prefetch:
                pf_plane = prefetch_init(args.prefetch_slots,
                                         cfg.embedding_dim, device)

    # checkpoints hold the reference's tree {params, opt, esd, qres}
    params = list(model.parameters())
    paths = ref_paths(model)
    esd_seen = {}    # step -> post-advance cache state, for checkpoints

    def trained(i):
        """Step i's train has been issued and step i+1's has not: the
        parameters hold i + 1 updates (at depth >= 2 the record of step i
        is built a drain later, after step i+1's train has updated them
        in place), so a checkpoint of ``i + 1`` steps is written here."""
        esd_snap = esd_seen.pop(i, None)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            train_tree(params, paths, step.state, esd_snap))

    start = 0
    if args.resume:
        restored, start = restore_checkpoint(
            args.ckpt_dir, train_tree(params, paths, step.state, esd))
        esd = load_train_tree(restored, params, paths, step.state)
        _sync(device)          # restored on the caller's stream
        if esd is not None:
            streams.take(getattr(esd, f.name)
                         for f in dataclasses.fields(esd))
        if args.verbose:
            log_step({"resumed_from_step": start})

    # the host batch stream, drawn on a loader thread as the reference
    # draws it, with the lookahead window's dedup meta
    host = PrefetchLoader(wl.stream(args.seed + 1, k), depth=2)
    src = iter(LookaheadWindow(host, args.lookahead, key=lambda b: b[0])
               if args.lookahead > 0 else ((b, None) for b in host))
    # resume: the stream is a pure function of the seed, so skipping the
    # first `start` batches re-aligns it with the interrupted run
    for _ in range(start):
        next(src)

    def device_batches():
        for (sparse, dense, labels), meta in src:
            with streams.chain():         # an upload waits for its stream
                batch = (torch.as_tensor(sparse.astype(np.int32),
                                         device=device),
                         torch.as_tensor(dense, device=device),
                         torch.as_tensor(labels, device=device))
            yield batch, meta

    if not use_esd:
        batches = device_batches()
        for i in range(start, args.steps):
            (sparse, dense, labels), meta = next(batches)
            if part is not None:
                sparse = part.to_linear(sparse)
            loss = train_step((sparse, dense, labels))
            trained(i)
            record(i, loss, None, meta, {})
    else:
        pf_cands = max(8 * args.prefetch, 256)
        # each stage counts its own steps: the chain may run ahead of
        # train, but every stage sees its steps in order
        dec_step, adv_step, rea_step, train_i = (itertools.count(start)
                                                 for _ in range(4))
        pull_done = None      # event after the latest prefetch pull
        fault_arrays = None
        if plan is not None:
            # the plan folded into every step's link times, cost bias
            # (stragglers, finite dead-worker penalty) and membership
            # mask, uploaded once; a step reads its rows
            def fault_np(i):
                cs = plan.state_at(i)
                t_eff = effective_t(t_np, cs)
                bias = cost_column_bias(t_eff, wl.width, cs.active,
                                        cs.compute_factor,
                                        args.compute_time_s)
                return (t_eff.astype(np.float32), bias.astype(np.float32),
                        cs.active)

            cols = list(zip(*(fault_np(i) for i in range(start, args.steps))))
            with streams.chain():
                table = [torch.as_tensor(np.stack(c), device=device)
                         for c in cols]

            def fault_arrays(i):
                return tuple(c[i - start] for c in table)

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
                state = with_staged(state,
                                    staged_membership(pf_plane, V_space, i))
            extra = () if plan is None else fault_arrays(i)
            assign, alg1 = decide(state, batch[0][0], *extra)
            return assign, streams.to_host(alg1)

        def pull(sel):
            """The prefetch pull reads the table train updates in place:
            on the train stream at its place in host order, after the
            trains issued so far and before the next.  It writes the
            plane's rows in place, and nothing else reads or writes them
            (the selection and ``staged_membership`` read ids and expiry
            only), so they stay on the train stream."""
            nonlocal pf_plane, pull_done
            selected = streams.mark()
            with streams.trainer():
                streams.wait(selected)
                streams.give((sel.sel_ids, sel.sel_slot, pf_plane.rows))
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
                memb = staged_membership(pf_plane, V_space, i)
                x, new_state, counts = advance(state, s, d, l, assign, memb)
                cids, cexp = prefetch_candidates(meta, i, pf_cands)
                sel = prefetch_select(
                    pf_plane, new_state.latest.any(dim=0),
                    torch.as_tensor(cids, device=device),
                    torch.as_tensor(cexp, device=device), i,
                    budget=args.prefetch)
                aux["prefetch_pulled"] = streams.to_host(sel.n_pulled)
                with get_tracer().span("prefetch.pull", track="prefetch",
                                       step=i):
                    pull(sel)
            else:
                extra = () if plan is None else fault_arrays(i)[2:]
                x, new_state, counts = advance(state, s, d, l, assign,
                                               *extra)
            if args.ckpt_dir:
                esd_seen[i] = new_state
            aux["counts"] = {key: streams.to_host(v)
                             for key, v in counts.items()}
            # the step's chain work and host copies are done at this event
            aux["ready"] = streams.mark()
            return (x, aux["ready"]), new_state, aux

        def train_fn(x):
            x, ready = x
            streams.wait(ready)
            streams.give(x)
            loss = streams.host_value(train_step(x))
            trained(next(train_i))
            return loss

        realized_fn = repair_fn = None
        if args.stale_decide or args.decide_ahead:
            @on_chain
            def realized_fn(state, batch, assign):
                extra = () if plan is None else fault_arrays(next(rea_step))
                return streams.to_host(realized(state, batch[0][0], assign,
                                                *extra))
        if args.decide_ahead:
            repair = make_dlrm_repair_stage(n, m, t_tran, part=part,
                                            cap_slack=args.cap_slack)

            @on_chain
            def repair_fn(committed, decided, batch, assign):
                a2, n_re = repair(committed, decided, batch[0][0], assign)
                return a2, {"n_reassigned": streams.to_host(n_re)}

        def record_fn(t, loss, aux, info):
            if aux["ready"] is not None:
                aux["ready"].synchronize()
            return record(start + t, loss, aux["counts"], aux["meta"], info,
                          aux.get("prefetch_pulled"))

        runner = PipelinedRunner(
            decide_fn, advance_fn, train_fn, esd, depth=depth,
            stale=args.stale_decide, realized_cost_fn=realized_fn,
            decide_ahead=args.decide_ahead, repair_fn=repair_fn)
        runner.run(device_batches(), steps=args.steps - start,
                   record_fn=record_fn)
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
        if traced_from is not None:
            _device_ms_into_spans(tracer, traced_from, stage_s)
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


# the runner's span of each stage whose CUDA event pair the driver keeps
_DEVICE_SPANS = {"decide": "decide", "advance": "advance",
                 "train.sync": "train"}


def _device_ms_into_spans(tracer, since: float, stage_s: dict) -> None:
    """Write each stage's device time into the args of its step's span
    (``device_ms``), for the spans ``tracer`` recorded from trace time
    ``since`` on (this run's).  ``stage_s[stage][k]`` is the k-th call of
    the stage, in seconds; each stage sees the runner's steps in order,
    so the k-th call is step k's (in the decide-ahead chain too, where
    decide runs for the step it pulls).  The tracer keeps a span's args
    by reference, so this reaches the spans it has recorded."""
    for ev in tracer.events():
        stage = _DEVICE_SPANS.get(ev["name"])
        t = ev["args"].get("step")
        if (stage is not None and t is not None and ev["ts"] >= since
                and t < len(stage_s[stage])):
            ev["args"]["device_ms"] = stage_s[stage][t] * 1e3


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
                    default="sparse",
                    help="touched-ids (sparse) or full-plane (dense) cache "
                         "engine")
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
    ap.add_argument("--n-ps", type=int, default=1,
                    help="partition the embedding vocabulary over this many "
                         "parameter servers")
    ap.add_argument("--ps-layout", choices=("contiguous", "hashed"),
                    default="contiguous")
    ap.add_argument("--ps-hetero", action="store_true",
                    help="heterogeneous PS links: last PS 0.5 Gbps, the "
                         "rest 5 Gbps (needs --n-ps > 1)")
    ap.add_argument("--fault-plan", default=None,
                    help="fault schedule: the DSL (e.g. 'crash@3:1g; "
                         "rejoin@6:1w; straggle@2:0x4-10') or @file.json; "
                         "needs ESD and --exchange ragged")
    ap.add_argument("--compute-time-s", type=float, default=0.010,
                    help="nominal compute time a step; prices a "
                         "straggler's slowdown into the dispatch cost")
    ap.add_argument("--codec", default=None,
                    help="wire codec for embedding traffic: none (exact "
                         "fp32), fp16, int8, int4, or KIND:BLOCK for "
                         "per-block scale groups")
    ap.add_argument("--codec-policy", choices=("uniform", "bandwidth"),
                    default="uniform",
                    help="uniform: every link uses --codec; bandwidth: "
                         "links at or above the median get fp16, slower "
                         "links get --codec (priced into Alg. 1)")
    ap.add_argument("--ckpt-dir", type=Path, default=None,
                    help="write checkpoints here, in the reference's npz "
                         "layout")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir "
                         "(parameters, optimizer, cache state, codec "
                         "residual) and continue from its step")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--verbose", action="store_true", default=True)
    ap.add_argument("--trace-out", type=Path, default=None,
                    help="export a Chrome/Perfetto trace_event JSON of "
                         "the run's spans (decide/advance/train/prefetch/"
                         "loader/io tracks) to this path; open it in "
                         "chrome://tracing or ui.perfetto.dev")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="tracer ring-buffer capacity in spans "
                         "(drop-oldest)")
    ap.add_argument("--validate-timing", action="store_true",
                    help="after the run, join traced per-stage wall "
                         "times against the per-step model predictions "
                         "(Alg.-1 est/realized cost, transmission cost) "
                         "and print the prediction-error / ordering-"
                         "agreement report to stderr")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def run_lm(args, model=None, cfg=None) -> dict:
    """Next-token training of a dense, MoE, SSM or hybrid LM for
    ``args.steps`` steps; returns the summary: the per-step records
    (``metrics``: loss,
    wall_s), the mean ms per step and tokens per second over the steps
    after the first (which builds the kernel and warms the allocator).
    The VLM and audio families exit (the driver feeds ``{tokens,
    labels}`` only, as the reference's, whose ``train_loss`` then fails
    on the missing ``patches`` or ``frames``).  ``model``
    replaces the seeded random weights (tests pass the JAX package's),
    ``cfg`` the config of ``--arch`` (a variant of it, such as another
    dtype)."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in api.LM_FAMILIES:
        raise SystemExit(
            f"the LM driver feeds tokens only ({{tokens, labels}}), as the "
            f"reference's does; the {cfg.family} family ({cfg.name}) trains "
            f"through launch.steps.make_train_step over "
            f"models.api.make_train_batch")
    if model is None:
        model = api.init_model(cfg, generator=torch.Generator(
            device=device).manual_seed(args.seed), device=device)
    step = make_lm_train_step(cfg, model, get_optimizer("adam", args.lr),
                              remat=False)
    params = list(model.parameters())
    paths = backbone.ref_paths(model, cfg)
    start = 0
    if args.resume:
        if args.ckpt_dir is None:
            raise SystemExit("--resume needs --ckpt-dir")
        restored, start = restore_checkpoint(
            args.ckpt_dir, train_tree(params, paths, step.state))
        load_train_tree(restored, params, paths, step.state)
        if args.verbose:
            log_step({"resumed_from_step": start})
    B, S = args.batch_per_worker, args.seq_len
    stream = PrefetchLoader(token_stream(args.seed, cfg.vocab, B, S + 1),
                            depth=2)
    for _ in range(start):
        next(stream)
    reg = MetricsRegistry()
    set_registry(reg)
    for i in range(start, args.steps):
        tok = next(stream)
        t0 = time.perf_counter()
        with get_tracer().span("train.sync", track="train/0", step=i):
            tok = torch.as_tensor(tok, device=device)
            loss = float(step({"tokens": tok[:, :-1],
                               "labels": tok[:, 1:]}))
        rec = reg.record_step(i, {"loss": loss,
                                  "wall_s": time.perf_counter() - t0})
        if args.verbose and (i % args.log_every == 0 or i == args.steps - 1):
            log_step(rec)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            train_tree(params, paths, step.state))
    walls = [r["wall_s"] for r in reg.steps]
    walls = walls[1:] or walls
    step_ms = float(np.mean(walls)) * 1e3 if walls else None
    return {"metrics": reg.steps, "device": str(device), "arch": cfg.name,
            "batch": B, "seq_len": S, "steps": len(reg.steps),
            "step_ms_mean": step_ms,
            "tokens_per_s": B * S / (step_ms * 1e-3) if step_ms else None}


def main(argv=None) -> dict:
    """Run the driver on ``argv``; returns the run's summary.  With
    ``--trace-out`` or ``--validate-timing`` the run is traced (see the
    module docstring)."""
    args = build_parser().parse_args(argv)
    trace = args.trace_out is not None or args.validate_timing
    tracer = Tracer(capacity=args.trace_buffer) if trace else None
    prev = set_tracer(tracer) if trace else None
    try:
        if args.arch in DLRM_CONFIGS:
            summary = run_dlrm(args)
        else:
            summary = run_lm(args)
    finally:
        if trace:
            set_tracer(prev)
            if args.trace_out is not None:
                tracer.export(args.trace_out)
    if trace:
        if tracer.dropped:
            print(f"trace ring dropped {tracer.dropped} oldest spans "
                  f"(--trace-buffer {args.trace_buffer})", file=sys.stderr)
        if args.verbose:
            print("== top spans by total wall time ==", file=sys.stderr)
            for row in tracer.durations(10):
                print(f"  {row['name']:<22} n={row['count']:<6} "
                      f"total={row['total_s']:.4f}s "
                      f"mean={row['mean_s'] * 1e3:.3f}ms "
                      f"max={row['max_s'] * 1e3:.3f}ms", file=sys.stderr)
        if args.validate_timing:
            report = validate_timing(tracer.events(), summary["metrics"])
            print(format_report(report), file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
