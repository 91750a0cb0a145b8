"""The training step's advance stage, in two checkouts in turns.

    python3 scripts/ab_advance.py --other PATH [--order ABBA]

Runs, in a fresh process from the root of each checkout (this one, "B",
and the one at ``--other``, "A", e.g. an earlier commit unpacked with
``git archive``), in the order given (A, B, B, A by default, so that a
drift of the card's clocks shows): ``chip_smoke.py``'s timings at the
training step's shapes (``phase_train_kernels``: B1, the row packs and,
where the checkout has it, the one-launch pack) and at the quantized
wire's (``phase_quant_kernels``: the pack-quantize alone, the pooled
lookup over the int8 wdl-s1 table at E = 512 and 4, and, where the
checkout has it, the one-launch pack with the dense features
quantized), then the wdl-s1
training driver ``run_dlrm`` at ``chip_smoke.TRAIN_ARGV`` (4 workers x
256, ESD alpha 1, ragged exchange, caches of 0.2 V, 10 steps, seed 0),
exact and with ``--codec int8``: the decide, advance and train stages'
host ms a step (each ended by a synchronise; mean of steps 1-9), the
advance's ms step by step, and the kernel launches a step.  Then it
checks that every run trained alike: the cache counts and the auction's
rounds of every step equal, the losses equal or within 1e-5 (the
gradient scatter adds in the order its atomics land).  Prints the card's
name and power limit first.  Needs a CUDA device; exits non-zero without
one or when the runs differ.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

SNIPPET = r'''
import json, statistics, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import _build
from repro_torch.kernels import auction as A
from repro_torch.launch.train import build_parser, run_dlrm

_build.load_libraries("emb_lookup", "exchange_pack", "auction")
chip_smoke.phase_train_kernels(0)
chip_smoke.phase_quant_kernels(0)
for codec in (None, "int8"):
    argv = chip_smoke.TRAIN_ARGV + ["--seed", "0"]
    if codec is not None:
        argv += ["--codec", codec]
    A.ROUNDS_LOG = []
    chip_smoke._zero_launches()
    out = run_dlrm(build_parser().parse_args(argv))
    launches = {k: v for k, v in chip_smoke._read_launches().items() if v}
    rounds = [r.sum(dim=1).tolist() for r in A.ROUNDS_LOG]
    A.ROUNDS_LOG = None
    recs = out["metrics"]
    advance = [round(x * 1e3, 3) for x in out["stage_s"]["advance"]]
    print(f"[ab] codec {codec or 'none'}: decide "
          f"{out['decide_ms_mean']:.3f}, advance "
          f"{out['advance_ms_mean']:.3f}, train {out['train_ms_mean']:.3f} "
          f"ms a step (mean of steps 1-9); advance ms by step {advance}; "
          f"launches a step "
          f"{ {k: v / len(recs) for k, v in launches.items()} }")
    print("[ab-run] " + json.dumps({
        "codec": codec, "loss": [r["loss"] for r in recs],
        "counts": [[r[k] for k in ("miss_pull", "update_push",
                                   "evict_push")] for r in recs],
        "rounds": rounds}))
'''


def same_training(runs: list[dict]) -> bool:
    """Every run's cache counts and rounds equal the first's, its losses
    within 1e-5."""
    ok = True
    for codec in {r["codec"] for r in runs}:
        mine = [r for r in runs if r["codec"] == codec]
        first = mine[0]
        for r in mine[1:]:
            exact = (r["counts"] == first["counts"]
                     and r["rounds"] == first["rounds"])
            loss = np.asarray(r["loss"])
            want = np.asarray(first["loss"])
            rel = float(np.max(np.abs(loss - want) / np.abs(want)))
            print(f"[ab] codec {codec or 'none'}: counts and rounds equal "
                  f"{exact}; losses equal {bool((loss == want).all())}, "
                  f"max relative difference {rel:.3g}")
            ok = ok and exact and rel <= 1e-5
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    trees = {"A": args.other.resolve(), "B": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    rc, runs = 0, []
    for name in args.order:
        print(f"===== {name}: {trees[name]}", flush=True)
        out = subprocess.run([sys.executable, "-c", SNIPPET],
                             cwd=trees[name], capture_output=True, text=True,
                             timeout=900)
        for ln in out.stdout.splitlines():
            if ln.startswith(("[kernel]", "[ab]")):
                print(ln, flush=True)
            elif ln.startswith("[ab-run] "):
                runs.append(json.loads(ln[len("[ab-run] "):]))
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            rc = 1
    if not same_training(runs):
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
