"""Run one cell of the benchmark once on a CUDA card:

    python3 esdbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

prints the result as the last line of standard output, and each number
the check compared beside its limit as the last lines of standard
error.  Without a card (or with fewer than the cell asks for) it exits
with code 2, and if the run loaded JAX or the JAX package with code 3,
printing no result.

The stream's processes start first, so that they draw beside the
imports, the card's start and the weights; they import numpy only, and
what follows the ``__main__`` check is not run again in them."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build cache at a fixed place inside the checkout (the port's
# CUDA kernels build into build/kernels/ by themselves)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
# one process with few threads: no host thread pool spins beside the
# interpreter, which paces decide and advance
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def main(argv=None) -> int:
    import argparse
    import json

    from esdbench.feed import Feed, stop_helpers
    from esdbench.manifest import Bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    try:
        with Feed(bench.config(cell["config"]), bench.mix(cell["traffic"]),
                  args.seed) as feed:
            import torch

            from esdbench.harness import _log, loaded_forbidden, run_cell
            chips = cell["chips"]
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < chips:
                found = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
                _log(f"needs {chips} CUDA card(s): {found} found")
                return 2
            result = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), root=ROOT, t_start=T_START,
                              feed=feed)
    finally:
        stop_helpers()
    found = loaded_forbidden()
    if found:
        _log(f"modules loaded that the run may not hold: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
