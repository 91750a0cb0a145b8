"""Wall time a step of the pipelined wdl-s1 training step, by depth.

    python3 scripts/pipeline_wall.py [--steps 20] [--codec int8] [--loader]
                                     [--readme]

Runs ``run_dlrm`` at chip_smoke.py's training configuration (wdl-s1, 4
workers of 256, ESD alpha 1, ragged exchange, caches of 0.2 V) on the
card, at depth 1 and depth 2 in turns (1, 2, 2, 1), exact and with each
``--codec`` given, and prints for each run the mean wall ms a step
(``wall_ms_mean``: after the first ``depth`` steps, each step ended by
its loss reaching the host), the stages' mean ms (depth 1: host time up
to a synchronise; depth 2: device time between CUDA events on each
stage's stream, and the host's issue time), and the host ms a batch of
the seeded stream takes to draw.  ``--loader`` adds depth-2 runs whose
host stream is drawn by a ``PrefetchLoader`` thread, as the reference's
driver draws it, to price the draw against the overlap.  ``--readme``
adds the README's configuration (decide-ahead 3, lookahead 4, 64 rows a
step prefetched into 512 slots) at depth 1 and depth 4 in turns (1, 4,
4, 1): the decide-ahead chain makes the same decisions at any depth.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARGV = ["--arch", "wdl-s1", "--workers", "4", "--batch-per-worker", "256",
        "--esd-alpha", "1", "--exchange", "ragged", "--capacity-ratio",
        "0.2", "--device", "cuda", "--seed", "0"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--codec", action="append", default=[])
    ap.add_argument("--loader", action="store_true")
    ap.add_argument("--readme", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pipeline_wall: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.data import synthetic
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.launch.train import build_parser, run_dlrm

    wl = synthetic.WORKLOADS["S1"]
    it = wl.stream(1, 1024)
    next(it)
    t = time.perf_counter()
    for _ in range(10):
        next(it)
    print(f"host stream: {(time.perf_counter() - t) / 10 * 1e3:.3f} ms a "
          f"batch of 1024 (S1)")

    readme = ["--lookahead", "4", "--decide-ahead", "3", "--prefetch", "64",
              "--prefetch-slots", "512"]

    def run(depth, codec, loader=False, flags=()):
        extra = ["--steps", str(args.steps), "--pipeline-depth", str(depth),
                 *flags]
        if codec:
            extra += ["--codec", codec]
        real = synthetic.CTRWorkload.stream
        if loader:
            synthetic.CTRWorkload.stream = (
                lambda self, seed, batch: PrefetchLoader(
                    real(self, seed, batch), depth=2))
        try:
            out = run_dlrm(build_parser().parse_args(ARGV + extra))
        finally:
            synthetic.CTRWorkload.stream = real
        host = out["host_ms_mean"] or {}
        print(f"RESULT depth {depth} codec {codec or 'none'}"
              f"{' loader' if loader else ''}"
              f"{' ' + ' '.join(flags) if flags else ''}: wall "
              f"{out['wall_ms_mean']:.3f}"
              f" ms a step; stages ({out['stage_clock']}) decide "
              f"{out['decide_ms_mean']:.3f}, advance "
              f"{out['advance_ms_mean']:.3f}, train "
              f"{out['train_ms_mean']:.3f}; host issue "
              + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
              + f"; walls {[r['wall_s'] for r in out['metrics']]}",
              flush=True)
        return [r["loss"] for r in out["metrics"]]

    for codec in [None] + args.codec:
        losses = []
        order = (1, 2, 2, 1)
        for depth in order:
            losses.append(run(depth, codec))
        if args.loader:
            losses.append(run(2, codec, loader=True))
        same = all(x == losses[0] for x in losses)
        print(f"codec {codec or 'none'}: losses equal across runs: {same}")
    if args.readme:
        losses = [run(depth, None, flags=readme) for depth in (1, 4, 4, 1)]
        print(f"README configuration: losses equal across runs: "
              f"{all(x == losses[0] for x in losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
