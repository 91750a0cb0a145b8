"""Reproduce the paper's headline comparison (Fig. 4) at laptop scale, on
the PyTorch port's simulator.

  PYTHONPATH=src python examples/simulate_paper_fig4_torch.py [--device cpu]

The port's counterpart of ``examples/simulate_paper_fig4.py``, with the
same scenarios and printout: the paper-faithful simulator (8 edge
workers, 4x 5 Gbps + 4x 0.5 Gbps, BSP + on-demand sync) over a
Criteo-shaped Zipf stream for ESD(alpha in {1, 0.5, 0}), LAIA, HET, FAE
and random dispatch, with speedup and cost reduction against LAIA as the
paper reports them; then three scenarios beyond the paper: two
parameter servers behind skewed links, the ragged exchange with
capacity slack, and lookahead dispatch pipelining.

Each scenario is a function of the ``base`` configuration that returns
its runs, ``{label: SimConfig keyword arguments}``; :func:`main` runs
them at ``BASE`` (40 iterations, as the reference does).  ``--device``
(the simulator's ``SimConfig.device``) defaults to ``cuda`` and raises
without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core import (SimConfig, hetero_ps_bandwidths,  # noqa: E402
                              simulate)
from repro_torch.data.synthetic import WORKLOADS  # noqa: E402

BASE = dict(workload=WORKLOADS["S2"], n_workers=8, batch_per_worker=64,
            cache_ratio=0.08, embedding_dim=512, iters=40, warmup=10)


def paper_runs(base: dict) -> dict:
    """Fig. 4: every mechanism on the paper's setting."""
    runs = {}
    for mech, alpha in [("laia", 0), ("esd", 1.0), ("esd", 0.5),
                        ("esd", 0.0), ("het", 0), ("fae", 0), ("random", 0)]:
        name = f"ESD(a={alpha})" if mech == "esd" else mech.upper()
        runs[name] = dict(mechanism=mech, alpha=alpha, **base)
    return runs


def hetero_ps_runs(base: dict) -> dict:
    """The V-space split over 2 parameter servers with skewed links (one
    5 Gbps PS, one 0.5 Gbps).  The ps-aware Alg. 1 charges a miss at the
    OWNING shard's link, so ESD steers samples whose ids are homed on
    the slow PS toward workers that already cache them."""
    hps = dict(base, n_ps=2,
               ps_bandwidths=hetero_ps_bandwidths(base["n_workers"], 2))
    runs = {}
    for mech, alpha, kw in [("esd", 1.0, {}), ("esd", 0.0, {}),
                            ("random", 0, {}),
                            ("het", 0, {"het_staleness": 2}),
                            ("fae", 0, {})]:
        name = f"ESD(a={alpha})" if mech == "esd" else mech.upper()
        runs[name] = dict(mechanism=mech, alpha=alpha, **kw, **hps)
    return runs


def ragged_runs(base: dict) -> dict:
    """Ragged exchange + capacity slack: with the ragged wire path the
    m/n cap can relax, the assignment skews toward cheap links, and the
    Alg.-1 objective drops, while the exchange ships bucketed blocks
    instead of worst-case uniform padding."""
    return {label: dict(mechanism="esd", alpha=0.0, **kw, **base)
            for label, kw in [
                ("padded, hard cap", dict(exchange="padded")),
                ("ragged, hard cap", dict(exchange="ragged")),
                ("ragged, slack 0.5", dict(exchange="ragged",
                                           cap_slack=0.5))]}


def pipelined_runs(base: dict) -> dict:
    """Lookahead dispatch pipelining on a tight LRU cache, so eviction
    pressure exists: the regime where the lookahead window's shield can
    cut miss pulls."""
    pbase = dict(base, alpha=1.0, mechanism="esd", cache_ratio=0.008,
                 policy="lru")
    return {label: dict(**kw, **pbase) for label, kw in [
        ("synchronous", dict(pipeline_depth=1)),
        ("pipelined", dict(pipeline_depth=2)),
        ("pipelined + W=8", dict(pipeline_depth=2, lookahead=8))]}


SCENARIOS = {"paper": paper_runs, "hetero_ps": hetero_ps_runs,
             "ragged": ragged_runs, "pipelined": pipelined_runs}


def run_all(runs: dict, on_result=None) -> dict:
    """``{label: SimResult}`` of ``runs``; ``on_result(label, r)`` sees
    each result as it lands."""
    out = {}
    for label, kw in runs.items():
        out[label] = simulate(SimConfig(**kw))
        if on_result is not None:
            on_result(label, out[label])
    return out


def main(argv=None, base: dict = None) -> None:
    """Run every scenario on ``base`` (default :data:`BASE`) and print
    the reference example's tables."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    args = ap.parse_args(argv)
    base = dict(BASE if base is None else base, device=args.device)

    results = run_all(paper_runs(base), lambda name, r: print(
        f"ran {name}: cost={r.cost:.4f}s itps={r.itps:.1f}"))
    ref = results["LAIA"]
    print(f"\n{'mechanism':14s} {'speedup':>8s} {'cost_red':>9s} "
          f"{'hit':>6s}")
    for name, r in results.items():
        print(f"{name:14s} {r.itps / ref.itps:8.2f} "
              f"{(ref.cost - r.cost) / ref.cost:9.2%} {r.hit_ratio:6.1%}")
    print("\npaper claims (testbed scale): ESD(a=1) up to 1.74x speedup "
          "and 36.76% cost reduction vs LAIA; ordering ESD(1) > ESD(0.5) "
          "> ESD(0).")

    print("\nheterogeneous parameter servers (n_ps=2: one fast, one slow "
          "link)")
    hres = run_all(hetero_ps_runs(base))
    href = hres["RANDOM"]
    print(f"{'mechanism':14s} {'cost':>10s} {'cost_red':>9s} {'hit':>6s}")
    for name, r in hres.items():
        print(f"{name:14s} {r.cost:10.4f} "
              f"{(href.cost - r.cost) / href.cost:9.2%} {r.hit_ratio:6.1%}")

    print("\nragged exchange + capacity slack (ESD a=0)")
    print(f"{'config':22s} {'alg1_cost':>10s} {'wire_MB':>8s} "
          f"{'pad_red':>8s}")
    rres = run_all(ragged_runs(base))
    for label, r in rres.items():
        ex = r.exchange
        print(f"{label:22s} {r.alg1_cost:10.4f} "
              f"{ex['wire_bytes'] / 1e6:8.2f} {ex['pad_reduction']:8.1%}")

    print("\npipelined vs synchronous ESD (a=1: decision ~ a full train "
          "step)")
    print(f"{'config':22s} {'itps':>7s} {'speedup':>8s} {'miss_ops':>9s} "
          f"{'hit':>6s}")
    pres = run_all(pipelined_runs(base))
    sref = pres["synchronous"]
    for label, r in pres.items():
        print(f"{label:22s} {r.itps:7.2f} {r.itps / sref.itps:8.2f} "
              f"{r.pipeline['miss_pull_total']:9d} {r.hit_ratio:6.1%}")
    p = pres["pipelined"]
    print("pipelined per-iteration time ~ max(train, decision): "
          f"{p.per_iter_time.mean() * 1e3:.1f} ms vs max "
          f"{max(p.pipeline['train_stage_mean_s'], p.pipeline['decision_stage_mean_s']) * 1e3:.1f} ms "
          f"(synchronous sums: {sref.per_iter_time.mean() * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
