"""Model-vs-measured timing validation.

The ESD stack *predicts* time all over the place — Alg. 1 estimates a
transmission cost before dispatch, the realized-cost pass prices the
committed assignment, and the exchange plan carries exact byte
accounting — but until now nothing joined those predictions against what
the traced wall clock actually measured.  :func:`validate_timing` takes
the tracer's events and the driver's per-step records and reports:

* ``stages`` — measured wall time per instrumented stage;
* ``overlap`` — how much decide time actually fell inside a train
  in-flight window (the pipelining promise, observed rather than
  simulated);
* ``alg1`` — estimated vs realized Alg.-1 cost: relative error plus
  pairwise ordering agreement (does the estimator at least *rank* steps
  correctly?), with the worst discordant step pairs flagged;
* ``predicted_vs_wall`` — per-stage join of the predicted transmission
  cost against the measured stage wall time: relative scale error and
  ordering agreement.  On a simulated-bandwidth CPU run the *scale* is
  expected to be off (the model prices a 5 Gbps edge link, the wall
  clock prices host Python); the *ordering* agreement is the meaningful
  signal — a cost model that mis-ranks steps would mis-dispatch.

Pure Python, copied line for line from the JAX package's module of the
same path, so one trace and one list of records give both packages the
same report and the same text.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

__all__ = ["validate_timing", "format_report"]


def _pairwise_ordering(xs: list[float], ys: list[float],
                       labels: list, flag_top: int = 5) -> dict:
    """Agreement between the orderings induced by xs (predicted) and ys
    (measured): concordant / discordant pair counts over all i<j pairs
    with distinct values on both sides, plus the worst discordant
    pairs."""
    n = len(xs)
    concordant = discordant = 0
    worst: list[tuple[float, object, object]] = []
    for i in range(n):
        for j in range(i + 1, n):
            dx, dy = xs[i] - xs[j], ys[i] - ys[j]
            if dx == 0 or dy == 0:
                continue
            if (dx > 0) == (dy > 0):
                concordant += 1
            else:
                discordant += 1
                worst.append((abs(dx) + abs(dy), labels[i], labels[j]))
    worst.sort(key=lambda w: -w[0])
    total = concordant + discordant
    return {
        "pairs": total,
        "concordant": concordant,
        "discordant": discordant,
        "agreement": concordant / total if total else None,
        "flagged": [{"a": a, "b": b} for (_, a, b) in worst[:flag_top]],
    }


def _rel_errors(pred: list[float], meas: list[float]) -> dict:
    errs = [abs(p - m) / abs(m) for p, m in zip(pred, meas) if m != 0]
    if not errs:
        return {"mean": None, "max": None}
    return {"mean": sum(errs) / len(errs), "max": max(errs)}


def _stage_table(events: list[dict]) -> dict:
    stages: dict[str, dict] = {}
    for ev in events:
        s = stages.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
        s["count"] += 1
        s["total_s"] += ev["dur"]
        s["max_s"] = max(s["max_s"], ev["dur"])
    for s in stages.values():
        s["mean_s"] = s["total_s"] / s["count"]
    return stages


def _overlap(events: list[dict]) -> dict:
    """Fraction of decide-span time spent inside a train in-flight
    window — the pipelining promise, measured: at depth 1 every window
    closes before the next decide starts (frac 0), at depth >= 2 the
    decide for step t+1 runs while step t is still in flight.  Train
    windows live on per-slot tracks ``train/<slot>`` (they can overlap
    each other at depth > 1 but are disjoint within a slot)."""
    trains = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
              if ev["name"] == "train"]
    decide_total = 0.0
    decide_hidden = 0.0
    for ev in events:
        if ev["name"] != "decide":
            continue
        a, b = ev["ts"], ev["ts"] + ev["dur"]
        decide_total += b - a
        # Union of intersections with train windows via a sweep over
        # merged intervals (windows from different slots may overlap).
        cuts = sorted((max(a, ta), min(b, tb)) for ta, tb in trains
                      if ta < b and tb > a)
        covered, cursor = 0.0, a
        for lo, hi in cuts:
            lo = max(lo, cursor)
            if hi > lo:
                covered += hi - lo
                cursor = hi
        decide_hidden += covered
    return {
        "decide_total_s": decide_total,
        "decide_hidden_s": decide_hidden,
        "hidden_frac": decide_hidden / decide_total if decide_total else None,
        "n_train_windows": len(trains),
    }


def _per_step_span(events: list[dict], name: str) -> dict[int, float]:
    out: dict[int, float] = {}
    for ev in events:
        if ev["name"] == name and "step" in ev["args"]:
            step = ev["args"]["step"]
            out[step] = out.get(step, 0.0) + ev["dur"]
    return out


def validate_timing(events: list[dict], steps: Iterable[dict],
                    flag_top: int = 5) -> dict:
    """Join traced events against per-step driver records; returns the
    report dict (see module docstring for the sections)."""
    steps = [s for s in steps if s is not None]
    report: dict = {
        "n_events": len(events),
        "n_steps": len(steps),
        "stages": _stage_table(events),
        "overlap": _overlap(events),
    }

    # Alg.-1 estimated vs realized cost (both model-side; measures how
    # much the pre-commit estimate drifts from the committed plan).
    est_real = [(s["step"], s["alg1_est"], s["alg1_realized"])
                for s in steps
                if s.get("alg1_est") is not None
                and s.get("alg1_realized") is not None]
    if est_real:
        lab, est, real = zip(*[(t, e, r) for t, e, r in est_real])
        report["alg1"] = {
            "n": len(est_real),
            "rel_error": _rel_errors(list(est), list(real)),
            "ordering": _pairwise_ordering(list(est), list(real),
                                           list(lab), flag_top),
        }
    else:
        report["alg1"] = None

    # Predicted transmission cost vs measured stage wall, per stage.
    cost_by_step = {s["step"]: s["cost"] for s in steps
                    if s.get("cost") is not None}
    pvw: dict[str, Optional[dict]] = {}
    for stage in ("decide", "train.sync"):
        walls = _per_step_span(events, stage)
        joined = sorted(t for t in walls if t in cost_by_step)
        if len(joined) < 2:
            pvw[stage] = None
            continue
        pred = [cost_by_step[t] for t in joined]
        meas = [walls[t] for t in joined]
        pvw[stage] = {
            "n": len(joined),
            "pred_mean_s": sum(pred) / len(pred),
            "wall_mean_s": sum(meas) / len(meas),
            "rel_error": _rel_errors(pred, meas),
            "ordering": _pairwise_ordering(pred, meas, joined, flag_top),
        }
    report["predicted_vs_wall"] = pvw
    return report


def _fmt(v, nd=4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if not math.isfinite(v):
            return str(v)
        return f"{v:.{nd}g}"
    return str(v)


def format_report(report: dict) -> str:
    """Human-readable multi-line rendering for the driver's
    ``--validate-timing`` summary (stderr)."""
    lines = ["== timing validation "
             f"({report['n_events']} spans, {report['n_steps']} steps) =="]
    lines.append("-- measured stage wall --")
    stages = sorted(report["stages"].items(),
                    key=lambda kv: -kv[1]["total_s"])
    for name, s in stages:
        lines.append(f"  {name:<20} n={s['count']:<5} "
                     f"total={_fmt(s['total_s'])}s "
                     f"mean={_fmt(s['mean_s'])}s max={_fmt(s['max_s'])}s")
    ov = report["overlap"]
    lines.append("-- decide/train overlap --")
    lines.append(f"  decide total {_fmt(ov['decide_total_s'])}s, hidden "
                 f"inside train windows {_fmt(ov['decide_hidden_s'])}s "
                 f"(frac={_fmt(ov['hidden_frac'])}, "
                 f"{ov['n_train_windows']} windows)")
    if report.get("alg1"):
        a = report["alg1"]
        lines.append("-- alg1 estimated vs realized --")
        lines.append(f"  n={a['n']} rel_err mean={_fmt(a['rel_error']['mean'])}"
                     f" max={_fmt(a['rel_error']['max'])} "
                     f"ordering agreement={_fmt(a['ordering']['agreement'])} "
                     f"({a['ordering']['discordant']} discordant pairs)")
        for p in a["ordering"]["flagged"]:
            lines.append(f"    disagree: step {p['a']} vs step {p['b']}")
    lines.append("-- predicted cost vs measured wall --")
    for stage, p in report["predicted_vs_wall"].items():
        if p is None:
            lines.append(f"  {stage:<12} (no joined steps)")
            continue
        lines.append(f"  {stage:<12} n={p['n']} "
                     f"pred_mean={_fmt(p['pred_mean_s'])}s "
                     f"wall_mean={_fmt(p['wall_mean_s'])}s "
                     f"rel_err mean={_fmt(p['rel_error']['mean'])} "
                     f"ordering agreement={_fmt(p['ordering']['agreement'])}")
    return "\n".join(lines)
