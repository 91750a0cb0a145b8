"""Quickstart on the PyTorch port: the ESD mechanism on one batch, end to
end.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, with the same
steps, seed and printout:

1. Build a synthetic CTR workload (Criteo-shaped Zipf streams).
2. Compute the Alg.-1 expected-transmission-cost matrix from live cache
   state under heterogeneous bandwidths.
3. Dispatch with HybridDis (Opt+Heu) and compare total expected cost
   against LAIA-style hit-count dispatch and random dispatch.
4. Run the cache protocol one iteration and show the actual miss-pull /
   update-push / evict-push counts.

Every step is numpy in :mod:`repro_torch.core` (HybridDis's Opt here is
SSP; ``device`` is where its auction would run).  ``--device`` defaults
to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core import (  # noqa: E402
    ClusterCache, cost_matrix_np, hybrid_dispatch, laia_dispatch,
    random_dispatch, transmission_time,
)
from repro_torch.data.synthetic import WORKLOADS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def main(argv=None) -> None:
    """Print the walk-through."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    wl = WORKLOADS["tiny"]
    n, m = 4, 32
    k = n * m

    # heterogeneous edge links: two 5 Gbps workers, two 0.5 Gbps (paper
    # default)
    bandwidth = np.array([5e9, 5e9, 0.5e9, 0.5e9]) / 8
    t_tran = transmission_time(512 * 4, bandwidth)
    print(f"per-embedding transfer cost (s): {t_tran}")

    cache = ClusterCache(n, wl.vocab, capacity=int(0.2 * wl.vocab))
    stream = wl.stream(seed=1, batch=k)

    # warm the caches for a few iterations with random dispatch
    for _ in range(5):
        samples, _, _ = next(stream)
        assign = random_dispatch(k, n, rng)
        cache.step([np.unique(samples[assign == j]) for j in range(n)])

    samples, _, _ = next(stream)
    latest, dirty = cache.snapshot()
    C = cost_matrix_np(samples, latest, dirty, t_tran)
    print(f"\ncost matrix: shape={C.shape}, mean={C.mean():.4g}, "
          f"row spread={np.mean(C.max(1) - C.min(1)):.4g}")

    plans = {
        "ESD(alpha=1)": hybrid_dispatch(C, m, alpha=1.0, opt="ssp",
                                        device=device),
        "ESD(alpha=0) [Heu]": hybrid_dispatch(C, m, alpha=0.0,
                                              device=device),
        "LAIA": laia_dispatch(samples, cache.latest_in_cache, m),
        "random": random_dispatch(k, n, rng),
    }
    print("\nexpected transmission cost by dispatch plan:")
    for name, a in plans.items():
        print(f"  {name:20s} {C[np.arange(k), a].sum():.5f} s")

    best = plans["ESD(alpha=1)"]
    stats = cache.step([np.unique(samples[best == j]) for j in range(n)])
    print(f"\nactual ops under ESD dispatch: "
          f"miss_pull={stats.miss_pull.sum()} "
          f"update_push={stats.update_push.sum()} "
          f"evict_push={stats.evict_push.sum()}")
    print(f"actual transmission cost: {stats.cost(t_tran):.5f} s")


if __name__ == "__main__":
    main()
