"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result line.

The loop is the port's ``PipelinedRunner`` over the program's decide,
advance and train stages, glued as ``run_dlrm`` glues them (the same
CUDA-event and host timing, the same stream rules at depth >= 2), fed
by the port's ``PrefetchLoader`` thread, which hands on the batches the
benchmark's generator draws in processes of its own (``feed.py``).
Set-up runs ``warmup_steps`` steps through that same loop (the ones
the reference follows; it trains beside the first ``checked_steps``),
then the window runs until ``--seconds`` have passed since the last set-up
step's loss reached the host.
"""
from __future__ import annotations

import gc
import itertools
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .feed import Feed
from .manifest import Bench
from .peaks import kept_slots, link_times, merged, union
from .reference.check import NUMBERS, judge, verdict
from .weights import make_weights

__all__ = ["FORBIDDEN", "Run", "run_cell", "loaded_forbidden"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STAGES = ("decide", "advance", "train")
# the profiled slice's clock markers: ``torch.cuda._sleep``'s kernel,
# which no program path launches, each spinning about half a millisecond
# and waited for; the profile has missed kernels in the first 3 ms after
# its start, so ten
MARKER, MARKERS, MARKER_CYCLES = "spin_kernel", 10, 1_000_000
_OPS = ("miss_pull", "update_push", "evict_push")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Slice:
    """The profiled slice of the window (``--trace 1``)."""
    t0: float = 0.0
    t1: float = 0.0
    decided: list = field(default_factory=list)
    advanced: list = field(default_factory=list)
    trained: list = field(default_factory=list)
    kernels: list = field(default_factory=list)   # (name, start us, end us)
    ranges: list = field(default_factory=list)    # (name, start us, end us)
    done: bool = False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return union([(s, e) for _, s, e in self.kernels]) * 1e-6


@dataclass
class Run:
    """What a run measured, for the end-to-end metrics and the readers."""
    cfg: dict
    mix: dict
    seconds: float
    k: int
    first: int                   # the first window step
    t0: float = 0.0              # the last set-up step's loss on the host
    deadline: float = 0.0
    rec: dict = field(default_factory=dict)        # step -> host time
    host_s: dict = field(default_factory=lambda: {s: [] for s in STAGES})
    events: dict = field(default_factory=lambda: {s: [] for s in STAGES})
    device_s: dict = field(default_factory=dict)   # stage -> [s by step]
    counts: dict = field(default_factory=dict)     # step -> {op: (n,)}
    rounds: dict = field(default_factory=dict)     # step -> [tensors]
    kept: dict = field(default_factory=dict)       # step -> Alg.-1 slots
    slice: Slice | None = None

    def window_steps(self) -> list:
        return sorted(t for t, at in self.rec.items()
                      if t >= self.first and at <= self.deadline)

    def steady_steps(self) -> list:
        """Window steps outside the profiled slice."""
        skip = set()
        if self.slice is not None:
            skip = set(self.slice.decided) | set(self.slice.trained)
        return [t for t in self.window_steps() if t not in skip]


def on_device_clock(kernels, marks, host_spans):
    """The profile's operations without the clock markers, and the
    host's ``(name, start s, end s)`` spans in the profile's us, placed by
    the last marker profiled against the last launched (a missed marker
    is one of the first); None for the spans where no marker was."""
    found = [k for k in kernels if MARKER in k[0]]
    ops = [k for k in kernels if MARKER not in k[0]]
    if not found:
        return ops, None
    at = found[-1][1] - marks[-1] * 1e6
    return ops, [(name, t0 * 1e6 + at, t1 * 1e6 + at)
                 for name, t0, t1 in host_spans]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _log(msg: str):
    print(f"[esdbench] {msg}", file=sys.stderr, flush=True)


def drive(subject, cfg, mix, seed, seconds, trace, device, feed=None):
    """Set-up and window through the runner, fed by ``feed`` (the cell's
    :class:`Feed` for ``seed``; one of its own, closed at the end, where
    none is given); returns the run and what the set-up steps produced,
    on the host."""
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.kernels import auction as KA
    from repro_torch.pipeline.runner import PipelinedRunner
    from repro_torch.pipeline.streams import ChainStreams

    n, m = mix["workers"], mix["batch_per_worker"]
    k = n * m
    depth = mix["pipeline_depth"]
    checked = mix["checked_steps"]
    W = mix["warmup_steps"]
    if W < checked:
        raise SystemExit("warmup_steps must cover the checked steps")
    run = Run(cfg, mix, seconds, k, W)
    if trace:
        run.slice = Slice()
        a = W + mix["trace_skip_steps"]
        slice_steps = range(a, a + mix["trace_steps"])
    prof = None
    streams = ChainStreams(device, enabled=depth > 1)
    out = {"assign": {}, "alg1": {}, "x": {}, "counts": {}, "loss": {}}
    dev_keep = {"assign": {}, "x": {}}
    norms = {}

    host_spans = []      # (what the host did, start, end) in the slice
    marks = []           # host time of each marker kernel's launch

    def span(name, t0):
        if profiling():
            host_spans.append((name, t0, time.perf_counter()))

    def timed(stage, fn):
        def go(*a):
            t0 = time.perf_counter()
            start = streams.mark(timing=True)
            res = fn(*a)
            if streams.enabled:
                run.events[stage].append((start, streams.mark(timing=True)))
            else:
                _sync(device)
            run.host_s[stage].append(time.perf_counter() - t0)
            span(stage, t0)
            return res
        return go

    def start_slice():
        # the device's activity only: host-side op tracing would slow the
        # slice's steps; the host's own spans label the idle gaps
        nonlocal prof
        _sync(device)
        acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        if device.type == "cuda":
            # marker kernels tie the profile's clock to the host's; the
            # profile can miss what the card runs just after its start,
            # so a few, each waited for, before the slice opens
            for _ in range(MARKERS):
                marks.append(time.perf_counter())
                torch.cuda._sleep(MARKER_CYCLES)
                _sync(device)
        run.slice.t0 = time.perf_counter()

    def stop_slice():
        _sync(device)
        run.slice.t1 = time.perf_counter()
        prof.stop()
        run.slice.done = True

    def read_slice():
        """The profile's device operations, read once the window has
        closed, and the host's spans on the profile's clock."""
        t_read = time.perf_counter()
        # the raw events, in us: no tree of host operations is built
        cuda = torch.autograd.DeviceType.CUDA
        kernels = sorted(((e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
                          for e in prof.profiler.kineto_results.events()
                          if e.device_type() == cuda), key=lambda k: k[1])
        _log(f"profiled slice: {run.slice.window_s:.3f} s, "
             f"{len(run.slice.trained)} trains, {len(kernels)} device "
             f"operations read in {time.perf_counter() - t_read:.3f} s")
        run.slice.kernels, ranges = on_device_clock(kernels, marks,
                                                    host_spans)
        # with none, the host's spans stay off the device clock
        _log(f"{len(kernels) - len(run.slice.kernels)} of {len(marks)} "
             f"clock markers profiled")
        run.slice.ranges = ranges or []

    def profiling() -> bool:
        return prof is not None and not run.slice.done

    def decide_body(state, sparse):
        assign, alg1 = subject.decide(state, sparse)
        return assign, streams.to_host(alg1)

    def advance_body(state, batch, assign, t):
        (s, d, l), meta = batch
        x, new_state, counts = subject.advance(state, s, d, l, assign)
        if t < W:
            # kept before the ready mark, which the record waits for
            dev_keep["x"][t] = tuple(v.clone() for v in x)
        aux = {"meta": meta,
               "counts": {key: streams.to_host(v)
                          for key, v in counts.items()}}
        aux["ready"] = streams.mark()
        return (x, aux["ready"]), new_state, aux

    decide_t = timed("decide", decide_body)
    advance_t = timed("advance", advance_body)
    train_t = timed("train", subject.train)
    dec_i, adv_i, tr_i = (itertools.count() for _ in range(3))

    def decide_fn(state, batch):
        t = next(dec_i)
        if trace and t == slice_steps.start:
            start_slice()
        if profiling():
            run.slice.decided.append(t)
        if trace and t >= W:
            KA.ROUNDS_LOG = [] if KA.ROUNDS_LOG is None else KA.ROUNDS_LOG
            r0 = len(KA.ROUNDS_LOG)
        with streams.chain():
            assign, alg1 = decide_t(state, batch[0][0])
            if t < W:
                dev_keep["assign"][t] = assign.clone()
        if trace and t >= W:
            run.rounds[t] = KA.ROUNDS_LOG[r0:]
        return assign, alg1

    def advance_fn(state, batch, assign):
        t = next(adv_i)
        if profiling():
            run.slice.advanced.append(t)
        with streams.chain():
            return advance_t(state, batch, assign, t)

    def train_fn(xr):
        x, ready = xr
        t = next(tr_i)
        if profiling():
            run.slice.trained.append(t)
        streams.wait(ready)
        streams.give(x)
        loss = streams.host_value(train_t(x))
        if t == 0:
            norms["grad"] = subject.grad_norms()
        if t == checked - 1:
            norms["change"] = subject.change_norms(seed)
        return loss

    def record_fn(t, loss, aux, info):
        t_in = time.perf_counter()
        if aux["ready"] is not None:
            aux["ready"].synchronize()
        loss = float(loss)
        now = time.perf_counter()
        run.rec[t] = now
        counts = aux["counts"]
        ov = int(counts["exchange_overflow"])
        if ov:
            raise RuntimeError(f"ragged exchange dropped {ov} rows")
        if t < W + mix["cost_steps"]:
            host = {op: np.asarray(torch.as_tensor(counts[op]).cpu())
                    for op in _OPS}
            if t >= W:
                run.counts[t] = host
        if t < checked:
            out["loss"][t] = loss
        if t < W:
            out["counts"][t] = host
            out["alg1"][t] = float(info["alg1_est"])
            out["assign"][t] = dev_keep["assign"].pop(t).cpu().numpy()
            out["x"][t] = tuple(v.cpu().numpy()
                                for v in dev_keep["x"].pop(t))
        if t == W - 1:
            # what set-up made is kept out of the window's collections
            gc.freeze()
            run.t0 = now
            run.deadline = now + seconds
            _log(f"set-up: {W} steps, the last {W - checked} in "
                 f"{now - run.rec[checked - 1]:.3f} s")
        span("record", t_in)
        if trace and profiling() and t == slice_steps.stop - 1:
            stop_slice()
        return {"step": t, "loss": loss}

    own = feed is None
    if own:
        feed = Feed(cfg, mix, seed)
    loader = PrefetchLoader(feed, depth=2)
    pulled = itertools.count()

    def device_batches():
        while True:
            t_in = time.perf_counter()
            try:
                sparse, dense, labels = next(loader)
            except StopIteration:
                return
            span("feed", t_in)
            if run.t0 and time.perf_counter() > run.deadline:
                return
            t = next(pulled)
            # decide runs up to depth steps ahead of the slice's trains
            if trace and slice_steps.start <= t < slice_steps.stop + depth:
                run.kept[t] = kept_slots(sparse)
            with streams.chain():
                batch = (torch.as_tensor(sparse, device=device),
                         torch.as_tensor(dense, device=device),
                         torch.as_tensor(labels, device=device))
            yield batch, None

    if trace and device.type == "cuda":
        # the profiler's first start sets up its tracing, and the marker
        # kernel's first launch loads it: in set-up, not in the window
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARKER_CYCLES)
            _sync(device)
    try:
        with streams.chain():
            state = subject.init_state()
        runner = PipelinedRunner(decide_fn, advance_fn, train_fn, state,
                                 depth=depth)
        runner.run(device_batches(), steps=None, record_fn=record_fn)
        streams.finish()
        _sync(device)
        if trace and profiling():
            stop_slice()
        if prof is not None:
            read_slice()
    finally:
        feed.stop.set()
        for _ in loader:
            pass
        loader._thread.join(timeout=60)
        if own:
            feed.close()
        KA.ROUNDS_LOG = None
        gc.unfreeze()
    if streams.enabled:
        run.device_s = {s: [a.elapsed_time(b) * 1e-3 for a, b in pairs]
                        for s, pairs in run.events.items()}
    run.rounds = {t: [r.cpu() for r in rs] for t, rs in run.rounds.items()}
    out = {key: [v[t] for t in range(checked if key == "loss" else W)]
           for key, v in out.items()}
    for key in ("grad", "change"):
        out[f"{key}_norms"] = {leaf: float(v)
                               for leaf, v in norms[key].items()}
    return run, out


def end_to_end(run: Run) -> dict:
    steps = run.window_steps()
    if len(steps) < run.mix["cost_steps"]:
        raise SystemExit(f"the window completed {len(steps)} steps, fewer "
                         f"than cost_steps {run.mix['cost_steps']}")
    times = [run.rec[t] - run.rec[t - 1] if t > run.first
             else run.rec[t] - run.t0 for t in steps]
    t_link = link_times(run.cfg["embedding_dim"],
                        run.mix["bandwidths_gbps"], run.mix["codec"])
    cost_s = sum(float((c[op] * t_link).sum())
                 for c in run.counts.values() for op in _OPS)
    n_cost = len(run.counts)
    _log(f"window: {len(steps)} steps in {run.seconds} s; step_ms_p95 "
         f"over {len(times)} steps; tx cost over {n_cost} steps")
    return {
        "samples_per_s": run.k * len(steps) / run.seconds,
        "step_ms_p95": float(np.percentile(np.asarray(times) * 1e3, 95)),
        "tx_cost_us_per_sample": cost_s / (n_cost * run.k) * 1e6,
    }


def breakdown(run: Run) -> dict:
    """The slice's ten device operations that took most time, and its
    idle time by the host range the host was in when each gap began."""
    sl = run.slice
    by_op = {}
    for name, s, e in sl.kernels:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    busy = merged([(s, e) for _, s, e in sl.kernels])
    gaps = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        inside = [r for r in sl.ranges if r[1] <= e0 < r[2]]
        label = max(inside, key=lambda r: r[1])[0] if inside else "other"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path, t_start: float, device: str = "cuda",
             subject: str = "program", here: Path | None = None,
             feed: Feed | None = None) -> dict:
    """One run, fed by ``feed`` where given (the cell's, for ``seed``);
    returns the result line's object.  ``device="cpu"`` and
    ``subject="control"`` are for the tests and the calibration, never
    for a benchmark run."""
    bench = Bench(root) if here is None else Bench(root, here)
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    dev = torch.device(device)
    if device == "cuda":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        _log(f"imports done at {time.perf_counter() - t_start:.3f} s")
        torch.zeros(1, device=dev)
        _log(f"card ready at {time.perf_counter() - t_start:.3f} s: "
             f"{_power_line()}")
    weights = make_weights(cfg, seed, dev)
    _log(f"weights made at {time.perf_counter() - t_start:.3f} s")
    if subject == "program":
        from .program import Program
        subj = Program(cfg, mix, weights, dev)
    else:
        from .reference.control import Control
        subj = Control(cfg, mix, weights, dev)
    del weights
    run, out = drive(subj, cfg, mix, seed, seconds, trace, dev, feed)
    attempted = len(run.window_steps())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    e2e = end_to_end(run)
    e2e["setup_s"] = run.t0 - t_start
    del subj
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    detail = {}
    num = judge(cfg, mix, seed, out, dev, detail)
    above = detail.get("above_least") or [(None, 0.0)]
    _log(f"reference check: {time.perf_counter() - t_check:.3f} s over "
         f"{mix['warmup_steps']} steps; transfers compared: "
         f"{detail.get('moved')}; steps above the least split: "
         f"{len(detail.get('above_least', []))}, the worst "
         f"{max(above, key=lambda g: g[1])}")
    limits = cfg["limits"]
    correct = verdict(num, limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0}
    if trace:
        metrics = {}
        for m in bench.per_layer(cell):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if run.slice.done:
            device_info["busy_s"] = run.slice.busy_s
            device_info["window_s"] = run.slice.window_s
        result["metrics"] = metrics
        result["device"] = device_info
        if run.slice.done and run.slice.kernels:
            result["breakdown"] = breakdown(run)
    else:
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in bench.end_to_end(cell)}
        result["device"] = device_info
    result["checked"] = {key: {"value": num[key], "limit": limits.get(key)}
                         for key in NUMBERS}
    for key in NUMBERS:
        print(f"check {key} {num[key]!r} limit {limits.get(key)!r}",
              file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    return result
