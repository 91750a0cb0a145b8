"""End-to-end driver on the PyTorch port: train a WDL DLRM for a few
hundred steps with ESD dispatch inside the step, and compare the
accumulated transmission cost of HybridDis Opt (alpha=1) against
Heu-only (alpha=0).

  PYTHONPATH=src python examples/train_dlrm_esd_torch.py [--steps 200] \
      [--tiny] [--device cpu]

The port's counterpart of ``examples/train_dlrm_esd.py``, through
:func:`repro_torch.launch.train.main`: with the default S1 workload the
WDL embedding table is ~502k rows x 512 dims (~257M params); ``--tiny``
takes wdl-tiny for a quick run.  Each run's cost is the sum of its
records' ``cost`` after the first 5 steps (warm-up), its final loss the
mean of the last 10 losses.  ``--device`` defaults to ``cuda`` and
raises without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.launch import train as train_mod  # noqa: E402

RUNS = [("esd_opt(a=1)", 1.0), ("esd_heu(a=0)", 0.0)]


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--bpw", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def driver_argv(args, alpha: float) -> list:
    """The driver's arguments for one run of the example."""
    arch = "wdl-tiny" if args.tiny else "wdl-s1"
    return ["--arch", arch, "--steps", str(args.steps),
            "--batch-per-worker", str(args.bpw), "--log-every", "50",
            "--esd-alpha", str(alpha), "--device", args.device]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    runs = {}
    for label, alpha in RUNS:
        print(f"== {label} ==")
        metrics = train_mod.main(driver_argv(args, alpha))["metrics"]
        costs = [m.get("cost", 0.0) for m in metrics[5:]]   # skip warm-up
        losses = [m["loss"] for m in metrics]
        runs[label] = dict(cost=float(np.sum(costs)),
                           final_loss=float(np.mean(losses[-10:])))
        print(f"{label}: total transmission cost {runs[label]['cost']:.4f} "
              f"s, final loss {runs[label]['final_loss']:.4f}")

    red = 1 - runs["esd_opt(a=1)"]["cost"] / max(runs["esd_heu(a=0)"]["cost"],
                                                 1e-12)
    print(f"\nESD Opt vs Heu cost reduction: {red:.1%}")
    print("(losses match: dispatch preserves the model — paper Sec. 3)")
    return runs


if __name__ == "__main__":
    main()
