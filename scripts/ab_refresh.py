"""The serving plane's TTL refresh: the out-of-place sequence around B3
(``staged_gather``) against the in-place ``plane_refresh``, in one
process, on the same inputs; the training prefetch pull's
``staged_pull`` against ``staged_gather``; and, with ``--other``, the
serving run of ``chip_smoke.py`` phase 5 in that checkout and in this
one, in turns.

    python3 scripts/ab_refresh.py [--other PATH] [--pairs 1] [--reps 100]

The refresh is timed at phase 5's shape (wdl-s1: V = 502,000, E = 512,
the 23,564-row hot-set plane, ``--refresh-budget 64``, ``--ttl-batches
32``) on two plane states: "ties" (every slot due with expiry 32 at step
32: a cold plane) and "spread" (expiries uniform in [0, 64) at step 32,
about half due), exact and with the int8 codec; each in-place call
takes a fresh copy of the state's expiry, so every call finds the same
backlog.  "was" is the
refresh_plane of the commit before the in-place refresh, rebuilt from
package functions: the compares, a stable ``argsort`` of every slot's
key, the rank scatter, ``staged_gather`` (or, with the codec, a gather
and ``fake_quant`` of all C rows and a select), the new expiry and the
count.  "now" is ``repro_torch.serve.refresh_plane``.  Both run on the
same plane state, "now" on a copy; their rows, expiry and counts are
checked bit for bit before the timing.  For each: the median device ms
and call ms of ``--reps`` calls (``chip_smoke.device_ms``), the median
host ms a call (the call alone, the device idle before it), and the
device launches of one call (``torch.profiler``'s CUDA kernel and memset
events), beside the bytes bound of the in-place refresh.  The pull at
the prefetch shape (64 of 512 slots) is timed for both kernels the same
way.

With ``--other`` (the parent commit unpacked with ``git archive``) each
serving run (phase 5's arguments: 4 workers, 2,000 QPS, 1 s exact, then
0.5 s with ``--codec int8``) is a subprocess of that checkout or this
one, run as other, this, this, other (``--pairs`` times); each prints
``run_serve``'s summary, whose ``worker_step_ms_mean`` is the host-clock
time of one worker's refresh, serve step and synchronise.  Prints the
card's name and power limit first.  Needs a CUDA device and ``nvcc``;
exits non-zero without them or when the two refreshes disagree.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

INT32_MAX = 2 ** 31 - 1
STEP, TTL, BUDGET = 32, 32, 64
SERVE_ARGV = ["--arch", "wdl-s1", "--workers", "4", "--qps", "2000",
              "--max-batch", "16", "--ttl-batches", "32",
              "--refresh-budget", "64", "--device", "cuda", "--seed", "0"]
SERVE_RUNS = {"exact": ["--duration", "1.0"],
              "int8": ["--duration", "0.5", "--codec", "int8"]}
RUNNER = """
import json, sys
from repro_torch.launch.serve import build_parser, run_serve
out = run_serve(build_parser().parse_args(sys.argv[1:]))
print("AB_SERVE " + json.dumps(out))
"""


def was_refresh(plane, table, step, *, ttl, budget, codec=None):
    """refresh_plane as it was before the in-place refresh: out of place,
    every slot's key sorted, all C rows through ``staged_gather`` (or the
    codec's gather and round trip)."""
    from repro_torch.kernels.emb_lookup import staged_gather
    from repro_torch.pipeline.prefetch import PrefetchPlane
    from repro_torch.quant.codecs import fake_quant, get_codec

    C, V = plane.ids.shape[0], table.shape[0]
    due = (plane.ids >= 0) & (plane.expiry <= step)
    order = torch.argsort(torch.where(due, plane.expiry, INT32_MAX),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C, device=order.device)
    due = due & (rank < budget)
    src = torch.where(due & (plane.ids >= 0), plane.ids.clamp(0, V - 1), -1)
    c = get_codec(codec)
    if c is None:
        rows = staged_gather(plane.rows, table, src)
    else:
        pulled = fake_quant(table[src.clamp(0, V - 1)], c)
        rows = torch.where((src >= 0)[:, None], pulled, plane.rows)
    new_exp = torch.where(due, int(step) + int(ttl), plane.expiry)
    return (PrefetchPlane(ids=plane.ids, rows=rows, expiry=new_exp),
            due.sum())


def host_ms(fn, reps: int) -> float:
    """Median host ms of one call, issued with the device idle."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def launches(fn) -> tuple[int, list]:
    """The device kernels and memsets one call issues."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names), names


def serve_ab(other: Path, pairs: int) -> None:
    rows = []
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    for name, root in order * pairs:
        for run, extra in SERVE_RUNS.items():
            root = root.resolve()
            env = dict(os.environ, PYTHONPATH=str(root / "src"))
            proc = subprocess.run(
                [sys.executable, "-c", RUNNER, *SERVE_ARGV, *extra],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            if proc.returncode:
                raise SystemExit(f"ab_refresh: the {name} serving run "
                                 f"failed:\n{proc.stderr[-4000:]}")
            out = json.loads([ln for ln in proc.stdout.splitlines()
                              if ln.startswith("AB_SERVE ")][-1][9:])
            rows.append((name, run, out))
            print(f"[ab-serve] {name} {run}: worker_step_ms_mean "
                  f"{out['worker_step_ms_mean']:.4f} x "
                  f"{out['worker_steps']}, decide_ms_mean "
                  f"{out['decide_ms_mean']:.4f}, p50 {out['p50_ms']:.3f} "
                  f"ms, p99 {out['p99_ms']:.3f} ms, refresh_rows "
                  f"{out['refresh_rows']}, n_requests {out['n_requests']}",
                  flush=True)
    for run in SERVE_RUNS:
        for name in ("other", "this"):
            ws = [o["worker_step_ms_mean"] for n, r, o in rows
                  if n == name and r == run]
            print(f"[ab-serve] {run} {name}: worker_step_ms_mean "
                  f"{', '.join(f'{w:.4f}' for w in ws)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--pairs", type=int, default=1,
                    help="serving rounds of other, this, this, other")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_refresh: no CUDA device")
    import chip_smoke as cs
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import _build
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.pipeline.prefetch import PrefetchPlane
    from repro_torch.serve import refresh_plane
    from repro_torch.serve.sim import _hot_set

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    _build.load_library("emb_lookup")
    wl = WORKLOADS["S1"]
    V, E = wl.vocab, 512
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    table = torch.randn((V, E), generator=g, device=dev) * 0.01
    hot = _hot_set(wl, np.random.default_rng(1), 2048, int(0.25 * V))
    C = len(hot)
    rows = torch.randn((C, E), generator=g, device=dev) * 0.01
    ids = torch.as_tensor(hot.astype(np.int32), device=dev)
    states = {"ties": np.full(C, STEP, np.int32),
              "spread": rng.integers(0, 2 * STEP, C).astype(np.int32)}
    lib = _build.load_library("emb_lookup")
    floor, floor_call = cs.device_ms(lambda: lib.empty_launch(
        torch.cuda.current_stream().cuda_stream), reps=args.reps)
    print(f"[ab] launch floor (an empty kernel): {floor:.4f} ms (call "
          f"{floor_call:.4f})")
    rc = 0
    for state, exp in states.items():
        n_due = int((exp <= STEP).sum())
        for codec in (None, "int8"):
            base = PrefetchPlane(ids=ids, rows=rows,
                                 expiry=torch.as_tensor(exp, device=dev))

            def fresh():
                return PrefetchPlane(ids=ids, rows=rows.clone(),
                                     expiry=base.expiry.clone())

            w_plane, w_n = was_refresh(base, table, STEP, ttl=TTL,
                                       budget=BUDGET, codec=codec)
            n_plane, n_n = refresh_plane(fresh(), table, STEP, ttl=TTL,
                                         budget=BUDGET, codec=codec)
            torch.cuda.synchronize()
            same = (int(w_n) == int(n_n)
                    and torch.equal(w_plane.rows, n_plane.rows)
                    and torch.equal(w_plane.expiry, n_plane.expiry))
            if not same:
                print(f"[ab] {state} codec {codec}: the refreshes differ")
                rc = 1
            # "now" refreshes in place: each call takes the next of 1,000
            # copies of the state's expiry (the rows are shared), so every
            # call finds the same backlog
            live = fresh()
            pool = itertools.cycle([PrefetchPlane(
                ids=ids, rows=live.rows, expiry=base.expiry.clone())
                for _ in range(1000)])
            fns = {"was": lambda: was_refresh(base, table, STEP, ttl=TTL,
                                              budget=BUDGET, codec=codec),
                   "now": lambda: refresh_plane(next(pool), table, STEP,
                                                ttl=TTL, budget=BUDGET,
                                                codec=codec)}
            times = {}
            for name in ("was", "now", "now", "was"):
                ms, call = cs.device_ms(fns[name], reps=args.reps)
                times.setdefault(name, []).append((ms, call))
            for name, fn in fns.items():
                h = host_ms(fn, args.reps)
                n_launch, names = launches(fn)
                dev_ms = ", ".join(f"{m:.4f}" for m, _ in times[name])
                call_ms = ", ".join(f"{c:.4f}" for _, c in times[name])
                print(f"[ab] refresh {state} (C={C}, due {n_due}, budget "
                      f"{BUDGET}) codec {codec or 'none'} {name}: device "
                      f"{dev_ms} ms, call {call_ms} ms, host {h:.4f} ms a "
                      f"call, {n_launch} launches a call "
                      f"({', '.join(sorted(set(n[:40] for n in names)))})")
            print(f"[ab] refresh {state} codec {codec or 'none'}: was and "
                  f"now bitwise equal: {same}")
    b_ms, b_by = cs.bound(C * 8 + BUDGET * E * 8 + BUDGET * 4, 0)
    print(f"[ab] plane_refresh bound {b_ms:.6f} ms ({b_by}: ids and expiry "
          f"read, {BUDGET} rows read and written, their slots)")

    # the training prefetch pull: 64 of 512 slots
    Cp, pulls = 512, 64
    plane_p = torch.randn((Cp, E), generator=g, device=dev) * 0.01
    slot = torch.as_tensor(rng.choice(Cp, pulls, replace=False)
                           .astype(np.int32), device=dev)
    src = torch.as_tensor(rng.choice(V, pulls, replace=False)
                          .astype(np.int32), device=dev)
    full = torch.full((Cp,), -1, dtype=torch.int32, device=dev)
    full[slot.long()] = src
    want = K.staged_gather(plane_p, table, full)
    got = K.staged_pull(plane_p.clone(), table, slot, src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        print("[ab] staged_pull differs from staged_gather")
        rc = 1
    fns = {"staged_gather": lambda: K.staged_gather(plane_p, table, full),
           "staged_pull": lambda: K.staged_pull(plane_p, table, slot, src)}
    times = {}
    for name in ("staged_gather", "staged_pull", "staged_pull",
                 "staged_gather"):
        times.setdefault(name, []).append(
            cs.device_ms(fns[name], reps=args.reps))
    for name, t in times.items():
        print(f"[ab] prefetch pull ({pulls} of {Cp} slots) {name}: device "
              f"{', '.join(f'{m:.4f}' for m, _ in t)} ms, call "
              f"{', '.join(f'{c:.4f}' for _, c in t)} ms")
    bp, bp_by = cs.bound(pulls * E * 8 + pulls * 8, 0)
    print(f"[ab] staged_pull bound {bp:.6f} ms ({bp_by})")
    if args.other is not None:
        serve_ab(args.other, args.pairs)
    return rc


if __name__ == "__main__":
    sys.exit(main())
