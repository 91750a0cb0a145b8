"""The readings a cell's limits are set from: the check's numbers for
the program over many seeds (the lower reading), for the control (the
reference one precision below, in the program's place) and for each
planted fault (the upper readings).  Each reading drives the cell's own
set-up steps at its own size through the harness and follows them with
the reference, as a run does; no window is measured.

    python3 esdbench/calibrate.py --workload <name> --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 [--faults a,b] [--out FILE]

prints one JSON line a reading: {"kind", "seed", "numbers"}."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from esdbench.faults import FAULTS, planted  # noqa: E402
from esdbench.harness import drive  # noqa: E402
from esdbench.manifest import Bench  # noqa: E402
from esdbench.reference.check import judge  # noqa: E402
from esdbench.weights import make_weights  # noqa: E402


def reading(cfg, mix, seed, device, subject="program", detail=None):
    mix = dict(mix, cost_steps=0)
    weights = make_weights(cfg, seed, device)
    if subject == "program":
        from esdbench.program import Program
        subj = Program(cfg, mix, weights, device)
    else:
        from esdbench.reference.control import Control
        subj = Control(cfg, mix, weights, device)
    del weights
    _, out = drive(subj, cfg, mix, seed, 0.0, False, device)
    del subj
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(cfg, mix, seed, out, device, detail)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default=",".join(FAULTS),
                    help="the planted faults to read, comma-separated")
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan = ([("program", None)] * args.seeds
            + [("control", None)] * args.control_seeds
            + [("fault", f) for f in args.faults.split(",") if f
               for _ in range(args.fault_seeds)])
    sink = open(args.out, "a") if args.out else None
    for i, (kind, fault) in enumerate(plan):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        detail = {}
        if fault is None:
            num = reading(cfg, mix, seed, device, kind, detail)
        else:
            with planted(fault):
                num = reading(cfg, mix, seed, device, detail=detail)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "fault": fault, "seed": seed, "numbers": num,
                           "detail": detail,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
