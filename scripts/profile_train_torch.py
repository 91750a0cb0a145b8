"""Profile the PyTorch port's ESD training step on one CUDA card.

    python3 scripts/profile_train_torch.py [--steps 14] [--warm 4] \
        [--codec int8]

Builds the training step as ``repro_torch.launch.train.run_dlrm`` does
(wdl-s1, 4 workers x 256, ESD alpha 1, ragged exchange, capacity 0.2;
with ``--codec``, over the quantized wire, the links priced uniformly),
runs ``--warm`` steps unprofiled, then profiles the rest with
``torch.profiler`` (CPU and CUDA activity), each stage inside a
``record_function`` range.  The advance stage is also split into its
parts, each a range wrapped around the functions that do it: the
exchange's packs (``advance.pack``: the slot maps and the row-pack
kernels), the whole exchange (``advance.exchange``: beyond the packs,
the transpose and the compaction) and the cache-state update
(``advance.state``: ``need_ids_list`` and ``esd_state_update_sparse``).
Prints, for each stage and part, its host ms a step (a stage's ends in
a synchronise; a part holds none, so its host time is the time to
enqueue its work), its launches a step and the time in which the
device ran any of the kernels it launched; the device's busy share of
the whole profiled window; the auction rounds per step (of the longest
of the workers' auctions); and the kernels that took most device time.
Writes the table to ``--out`` when given.  Needs a CUDA device;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


# advance's parts: (module, function, range); a function the checkout
# does not have is skipped, so the script splits the stage both before
# and after the one-launch pack
PARTS = (("repro_torch.launch.steps", "need_ids_list", "advance.state"),
         ("repro_torch.launch.steps", "esd_state_update_sparse",
          "advance.state"),
         ("repro_torch.launch.steps", "ragged_exchange", "advance.exchange"),
         ("repro_torch.launch.steps", "ragged_exchange_quant",
          "advance.exchange"),
         ("repro_torch.launch.steps", "ragged_exchange_many",
          "advance.exchange"),
         ("repro_torch.exchange.ragged", "pack_send", "advance.pack"),
         ("repro_torch.exchange.ragged", "_slots", "advance.pack"),
         ("repro_torch.exchange.ragged", "gather_rows_quant", "advance.pack"),
         ("repro_torch.exchange.ragged", "pack_send_all", "advance.pack"))


def _wrap_parts():
    import importlib

    def ranged(name, fn):
        def run(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return run

    for mod, fn, name in PARTS:
        module = importlib.import_module(mod)
        if hasattr(module, fn):
            setattr(module, fn, ranged(name, getattr(module, fn)))
    return sorted({name for *_, name in PARTS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="wdl-s1")
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.core.dispatch as D
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import auction as A
    from repro_torch.launch.steps import make_dlrm_esd_stages
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.dlrm import bce_loss, init_params
    from repro_torch.optim import rowwise_adagrad
    from repro_torch.quant.codecs import (codec_name, get_codec,
                                          resolve_link_codecs)

    parts = _wrap_parts()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = DLRM_CONFIGS[args.arch]
    wl = WORKLOADS[cfg.workload]
    n, m, V = 4, 256, wl.vocab
    cap = int(0.2 * V)
    codec = get_codec(args.codec)
    bw = DEFAULT_BANDWIDTHS(n)
    t = torch.tensor(transmission_time_codec(
        cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, codec)),
        dtype=torch.float32, device=dev)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        n, m, t, 1.0, exchange="ragged", capacity=cap, codec=codec)
    state = D.esd_sparse_init(n, V, cap, max_ids=out_rows * wl.width,
                              device=dev)
    model = init_params(cfg, wl, torch.Generator(device=dev)
                        .manual_seed(args.seed), dev)
    train = make_train_step(model, bce_loss, rowwise_adagrad(1e-2), codec)

    stream = wl.stream(args.seed + 1, n * m)
    host = {s: [] for s in ("decide", "advance", "train")}
    per_step_rounds = []

    def step(i, prof_on):
        nonlocal state
        s, d, l = next(stream)
        s = torch.as_tensor(s.astype(np.int32), device=dev)
        d, l = torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev)
        A.ROUNDS_LOG = []
        for name in ("decide", "advance", "train"):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                if name == "decide":
                    assign, _ = decide(state, s)
                elif name == "advance":
                    x, state, _ = advance(state, s, d, l, assign)
                else:
                    train(*x)
                torch.cuda.synchronize()
            if prof_on:
                host[name].append(time.perf_counter() - t0)
        # the longest of the workers' auctions, in rounds
        per_step_rounds.append(max(int(r.sum(dim=1).max())
                                   for r in A.ROUNDS_LOG))
        A.ROUNDS_LOG = None

    for i in range(args.warm):
        step(i, False)
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.warm, args.steps):
            step(i, True)
        wall_us = (time.perf_counter() - t0) * 1e6

    lines = [f"{smi}", f"[profile] {args.arch}, codec {codec_name(codec)}, "
             f"{n} workers x {m}, steps "
             f"{args.warm}..{args.steps - 1} profiled, auction rounds per "
             f"step {per_step_rounds}"]
    # each stage and part by the launches made inside its range on the
    # host: a kernel and its launch share a correlation id (a range's own
    # device span is not used, as the profiler drops it for a range that
    # holds another); nested calls of one range count once
    stages = ("decide", "advance", "train")
    ranges = stages + tuple(parts)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if e.name not in ranges]
    iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    n_prof = args.steps - args.warm
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith("cu") and any(
                    w in e.name for w in ("Launch", "Memcpy", "Memset"))}
    for name in ranges:
        host_iv = _merged([(e.time_range.start, e.time_range.end)
                           for e in cpu if e.name == name])

        def inside(t):
            return any(s0 <= t < s1 for s0, s1 in host_iv)

        # a stage's host time ends in its synchronise
        host_ms = (float(np.mean(host[name])) * 1e3 if name in stages
                   else _union_us(host_iv) / 1e3 / n_prof)
        n_launch = sum(1 for t in launched.values() if inside(t))
        dev_ms = _union_us([(e.time_range.start, e.time_range.end)
                            for e in kernels if e.id in launched
                            and inside(launched[e.id])]) / 1e3 / n_prof
        lines.append(f"[profile] {name}: host {host_ms:.3f} ms/step, "
                     f"{n_launch / n_prof:.1f} launches/step, device busy "
                     f"{dev_ms:.3f} ms/step ({dev_ms / host_ms:.1%})")
    busy = _union_us(iv)
    lines.append(f"[profile] window {wall_us / 1e3:.1f} ms, device busy "
                 f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), idle "
                 f"{1 - busy / wall_us:.1%}; {len(kernels)} kernels "
                 f"({len(kernels) / n_prof:.0f} per step)")
    by_kernel = {}
    for e in kernels:
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (cnt, us) in top:
        lines.append(f"[profile] kernel {us / 1e3 / n_prof:9.3f} ms/step "
                     f"{cnt / n_prof:8.1f} launches/step  {name[:110]}")
    lines.append(f"[profile] peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                 f"(profiled steps)")
    text = "\n".join(lines)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
