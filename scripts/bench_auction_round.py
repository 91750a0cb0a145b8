"""Time one round of the eps-scaled auction on one CUDA card.

    python3 scripts/bench_auction_round.py [--rounds 300] [--k 256] \
        [--n 8] [--cap 32]

A round is the bid kernel (``auction_bids``) and the slot matching in
PyTorch (``repro_torch.core.auction._bid_round``).  Prints the ms a round
takes on the host clock over ``--rounds`` rounds, launched four ways:
eagerly or as a replayed CUDA graph of one round, each with and without
the test for an unassigned row that the solver makes before every round
(a device-to-host copy).  Then the device time of the graph's kernels by
name, from ``torch.profiler``.  The rounds run at a tiny eps on random
costs, so they keep bidding.  Needs a CUDA device; exits non-zero
without one.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--cap", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_auction_round: needs a CUDA device")
    from repro_torch.core.auction import _bid_round, _write

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    k, n, cap, R = args.k, args.n, args.cap, args.rounds
    rng = np.random.default_rng(0)
    cost = torch.as_tensor(rng.random((k, n), dtype=np.float32), device=dev)
    eps = torch.tensor([1e-6], dtype=torch.float32, device=dev)

    def fresh():
        return (torch.full((1, k), -1, dtype=torch.int32, device=dev),
                torch.zeros((1, n, cap), dtype=torch.float32, device=dev),
                torch.full((1, n, cap), -1, dtype=torch.int32, device=dev))

    def per_round(step, state, test):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(R):
            if test:
                bool((state[0] < 0).any())
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / R * 1e3

    state = fresh()
    _write(state, _bid_round(cost, eps, state))          # warm-up round
    for test in (True, False):
        ms = per_round(lambda: _write(state, _bid_round(cost, eps, state)),
                       state, test)
        print(f"eager, {'with' if test else 'without'} the test: "
              f"{ms:.4f} ms a round (k = {k}, n = {n}, capacity {cap})")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _write(state, _bid_round(cost, eps, state))
    for test in (True, False):
        ms = per_round(graph.replay, state, test)
        print(f"graph, {'with' if test else 'without'} the test: "
              f"{ms:.4f} ms a round")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 20) for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith("aten::")]
    print(f"device time a round: {sum(t for _, t in rows):.1f} us; by "
          f"kernel (us a round):")
    for key, t in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t:8.2f}  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
