"""Run one cell of the benchmark once on a CUDA card:

    python3 esdbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

prints the result as the last line of standard output, and each number
the check compared beside its limit as the last lines of standard
error.  Without a card (or with fewer than the cell asks for) it exits
with code 2, and if the run loaded JAX or the JAX package with code 3,
printing no result."""
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

from esdbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
