"""Training driver on PyTorch (CUDA by default): the DLRM ESD step, and
next-token training of the dense LMs.

The counterpart of the JAX package's ``launch/train.py``.  DLRM mode:
``--workers`` edge workers share one device, the worker being a
leading tensor dimension.  A seeded Zipf CTR stream (``--seed`` + 1)
feeds, with ``--esd-alpha``, three stages per step
(:func:`repro_torch.launch.steps.make_dlrm_esd_stages`, driven by
:class:`repro_torch.pipeline.runner.PipelinedRunner` at depth 1):

  decide   Alg. 1 over each worker's touched ids, through the
           pooled-lookup kernel, then Alg. 2 (auction + greedy);
  advance  the sample exchange (``--exchange ragged``: every worker's
           ids, dense features and labels packed in one launch of the
           pack kernel) and the sparse cache-state update;
  train    the DLRM forward and backward on the exchanged batch, then
           row-wise Adagrad.

``--codec`` (fp16, int8, int4, ``int8:64`` …) turns on the quantized
wire: the exchange sends the dense features quantized (the fused
gather-quantize kernel), the train stage computes on the tables as the
wire delivers them (straight-through estimator) and pushes each table's
gradient through the codec with error feedback, and Alg. 1 prices every
link at the codec's bytes (``--codec-policy bandwidth``: fp16 on the
links at or above the median bandwidth, the codec below it).

Without ``--esd-alpha`` each step trains the batch as it comes.  Every
step logs the loss and, with ESD, the cache counts and their
transmission cost.  The summary adds the mean host-clock milliseconds of
each stage, each read after a device synchronise, over the steps after
the first (which builds the kernels and warms the allocator).  Model
weights are random, drawn from ``--seed``.

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
      --exchange ragged --capacity-ratio 0.2 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-tiny \\
      --workers 4 --batch-per-worker 8 --steps 3 --esd-alpha 1 \\
      --exchange ragged --device cpu
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
import time
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
from ..pipeline.runner import PipelinedRunner
from ..quant.codecs import (codec_name, get_codec, quantize_with_feedback,
                            resolve_link_codecs, row_wire_bytes, ste)
from ..device import resolve_device
from .steps import make_dlrm_esd_stages, raise_on_overflow
from .steps import make_train_step as make_lm_train_step

__all__ = ["build_parser", "make_train_step", "run_dlrm", "run_lm", "main"]


def _unported(args) -> None:
    """Raise on every flag of the reference this slice does not carry."""
    todo = [
        (args.pipeline_depth > 1, "--pipeline-depth > 1", "A8"),
        (args.stale_decide, "--stale-decide", "A8"),
        (args.decide_ahead > 0, "--decide-ahead", "A8"),
        (args.lookahead > 0, "--lookahead", "A8"),
        (args.prefetch > 0, "--prefetch", "A8"),
        (args.prefetch_slots != 512, "--prefetch-slots", "A8"),
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


def run_dlrm(args, model=None) -> dict:
    """Train ``args.steps`` steps; returns the summary: the per-step
    records (``metrics``) and the mean stage times.  ``model`` replaces
    the seeded random weights (tests pass the JAX package's)."""
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
    use_esd = args.esd_alpha is not None
    capacity = int(args.capacity_ratio * V)
    capacity = capacity if capacity < V else None     # None: no LRU cut
    if args.cap_slack > 0.0:
        if not use_esd:
            raise SystemExit("--cap-slack needs ESD (--esd-alpha)")
        if args.exchange != "ragged":
            raise SystemExit("--cap-slack > 0 needs --exchange ragged (the "
                             "padded all_to_all requires equal m/n groups)")
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

    reg = MetricsRegistry()
    stage_h = {s: reg.histogram(f"train.{s}_s", keep=True)
               for s in ("decide", "advance", "train")}

    def timed(stage, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            _sync(device)
            stage_h[stage].observe(time.perf_counter() - t0)
            return out
        return run

    train_step = timed("train", lambda x: step(*x))

    last_t = time.perf_counter()

    def record(i, loss, counts, info):
        nonlocal last_t
        now = time.perf_counter()
        rec = {"loss": float(loss), "wall_s": round(now - last_t, 4)}
        last_t = now
        if counts is not None:
            # loud failure on silent row loss
            raise_on_overflow(counts)
            base_ops = ("miss_pull", "update_push", "evict_push")
            ops = {op: counts[op].cpu().numpy() for op in base_ops}
            rec["cost"] = float(sum((ops[o] * t_np).sum() for o in ops))
            rec.update({op: int(v.sum()) for op, v in ops.items()})
            # no prefetch plane yet: every miss is a demand miss
            demand = int(ops["miss_pull"].sum())
            rec["prefetch_bytes"] = 0
            rec["demand_miss_bytes"] = demand * wire
            rec["prefetch_hit_rate"] = 0.0
        if "alg1_est" in info:
            rec["alg1_est"] = float(info["alg1_est"])
        rec = reg.record_step(i, rec)
        if args.verbose and (i % args.log_every == 0 or i == args.steps - 1):
            log_step(rec)
        return rec

    def device_batches():
        for sparse, dense, labels in wl.stream(args.seed + 1, k):
            yield (torch.as_tensor(sparse.astype(np.int32), device=device),
                   torch.as_tensor(dense, device=device),
                   torch.as_tensor(labels, device=device))

    if not use_esd:
        batches = device_batches()
        for i in range(args.steps):
            record(i, train_step(next(batches)), None, {})
    else:
        decide, advance, _, out_rows = make_dlrm_esd_stages(
            n, m, t_tran, args.esd_alpha, exchange=args.exchange,
            cap_slack=args.cap_slack, capacity=capacity, codec=codec)
        # L = out_rows * W ids per worker after the exchange
        esd = esd_sparse_init(n, V, capacity, max_ids=out_rows * wl.width,
                              device=device)
        decide_t = timed("decide", decide)
        advance_t = timed("advance", advance)

        def decide_fn(state, batch):
            return decide_t(state, batch[0])

        def advance_fn(state, batch, assign):
            x, new_state, counts = advance_t(state, *batch, assign)
            return x, new_state, {"counts": counts}

        runner = PipelinedRunner(decide_fn, advance_fn, train_step, esd,
                                 depth=args.pipeline_depth)
        runner.run(device_batches(), steps=args.steps,
                   record_fn=lambda t, loss, aux, info: record(
                       t, loss, aux["counts"], info))

    def mean_ms(h):
        xs = h.samples[1:] if len(h.samples) > 1 else h.samples
        return float(np.mean(xs)) * 1e3 if xs else None

    stages = {s: mean_ms(h) for s, h in stage_h.items()}
    step_ms = sum(v for v in stages.values() if v is not None)
    return {"metrics": reg.steps, "device": str(device), "workers": n,
            "batch": k, "steps": len(reg.steps), "codec": codec_name(codec),
            "decide_ms_mean": stages["decide"],
            "advance_ms_mean": stages["advance"],
            "train_ms_mean": stages["train"], "step_ms_mean": step_ms,
            "stage_s": {s: list(h.samples) for s, h in stage_h.items()},
            "samples_per_s": k / (step_ms * 1e-3) if step_ms else None}


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
    ap.add_argument("--pipeline-depth", type=int, default=1)
    ap.add_argument("--lookahead", type=int, default=0)
    ap.add_argument("--decide-ahead", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=0)
    ap.add_argument("--prefetch-slots", type=int, default=512)
    ap.add_argument("--stale-decide", action="store_true")
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
