"""Rounds and wall time of each auction decision of the port's simulator.

    PYTHONPATH=src python scripts/auction_rounds.py [--workload S1] \
        [--workers 8] [--bpw 32] [--iters 8] [--device cpu] \
        [--fault-plan "crash@2:3g; rejoin@5:3w; straggle@1:0x4-6; ..."]

Runs ``repro_torch.core.simulator.simulate`` with ESD alpha 1 and
``opt="auction"`` (the paper's 4 x 5 and 4 x 0.5 Gbps links, r = 0.08,
E = 512, the calibrated decision model, the first two iterations
warm-up) and prints, for every iteration's decision, the rounds the
eps-scaled auction took and its wall time on the host clock (the solver
returns numpy, so the time includes the device's work); then the run's
cost, ItpS and hit ratio.
Rounds, cost, ItpS and hit ratio are the same on every device (the
defaults are ``chip_smoke.py`` phase 8's S1 run); a time is a device
time only from a run on the card.  On the CPU, where the rounds run in
the plain version, each decision's line also gives the share of its
rounds by their number of bidders (unassigned rows), the most common
first.  The first decision meets a cold cache, whose tied rows and
tied columns start a price war (ROADMAP § C).  ``--fault-plan`` runs the
simulator under a fault plan (``repro_torch.elastic.FaultPlan.parse``)
and also prints the run's ``elastic`` accounting, per-iteration cost,
Alg.-1 cost and ingredient split.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="S1")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--bpw", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault-plan", default=None)
    args = ap.parse_args(argv)

    from repro_torch.core import auction, hybrid
    from repro_torch.kernels import auction as plain
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.elastic import FaultPlan

    decisions = []
    bidders = collections.Counter()     # rounds by bidders, plain version
    round_body = plain._round_body

    def counted_round(cost, eps, state):
        bidders[int((state[0] < 0).sum())] += 1
        return round_body(cost, eps, state)

    def timed_dispatch(cost, capacity, **kw):
        bidders.clear()
        t = time.perf_counter()
        out, rounds = auction.auction_dispatch(cost, capacity,
                                               return_rounds=True, **kw)
        decisions.append((rounds, time.perf_counter() - t))
        shares = ", ".join(f"{b}: {v / rounds:.1%}"
                           for b, v in bidders.most_common(4))
        print(f"decision {len(decisions) - 1}: k = {cost.shape[0]}, "
              f"n = {cost.shape[1]}, {rounds} rounds, "
              f"{decisions[-1][1] * 1e3:.1f} ms"
              + (f"; rounds by bidders {shares}" if bidders else ""),
              flush=True)
        return out

    plain._round_body = counted_round
    hybrid.auction_dispatch = timed_dispatch
    res = simulate(SimConfig(
        workload=WORKLOADS[args.workload], n_workers=args.workers,
        batch_per_worker=args.bpw, iters=args.iters, warmup=2,
        opt="auction", seed=args.seed, device=args.device,
        faults=(FaultPlan.parse(args.fault_plan, args.workers)
                if args.fault_plan else None)))
    rounds = sum(r for r, _ in decisions)
    secs = sum(s for _, s in decisions)
    print(f"{args.workload}, {args.workers} workers x {args.bpw}, "
          f"{args.iters} iterations on {args.device}: {rounds} rounds in "
          f"{len(decisions)} decisions, {secs:.2f} s, "
          f"{secs / max(rounds, 1) * 1e3:.4f} ms a round; cost {res.cost!r}, "
          f"itps {res.itps!r}, hit ratio {res.hit_ratio!r}")
    if res.elastic is not None:
        print(f"elastic {res.elastic!r}")
        print(f"per_iter_cost {res.per_iter_cost.tolist()!r}, alg1_cost "
              f"{res.alg1_cost!r}, ingredient {res.ingredient!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
