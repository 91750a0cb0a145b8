"""The decide stage's kernels and the auction, in two checkouts in turns.

    python3 scripts/ab_decide.py --other PATH [--order ABBA]

Runs, in a fresh process from the root of each checkout (this one, "B",
and the one at ``--other``, "A", e.g. an earlier commit unpacked with
``git archive``), in the order given (A, B, B, A by default, so that a
drift of the card's clocks shows): ``chip_smoke.py``'s B1 and B2
timings at the training step's shapes (``phase_train_kernels``); the
wdl-s1 training step's decide stage for 10 steps (4 workers x 256, ESD
alpha 1, ragged exchange, caches of 0.2 V, seed 0; host ms a step, each
ended by a synchronise; advance runs between the steps untimed); and the
S1 simulator's price war (256 x 8, two tied column blocks, capacity 32,
eps 1/257) through the public ``auction_solve``, at most 3,000 rounds a
phase (host ms and us a round).  Prints the card's name and power
limit first.  Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SNIPPET = r'''
import statistics, sys, time
import numpy as np, torch
sys.path.insert(0, "."); sys.path.insert(0, "src")
import chip_smoke
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.auction import auction_solve
from repro_torch.core.cost import transmission_time_codec
from repro_torch.core.dispatch import esd_sparse_init
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.kernels import _build
from repro_torch.launch.steps import make_dlrm_esd_stages
from repro_torch.quant.codecs import resolve_link_codecs

_build.load_libraries("emb_lookup", "exchange_pack", "auction")
chip_smoke.phase_train_kernels(0)
dev = torch.device("cuda")
cfg = DLRM_CONFIGS["wdl-s1"]
wl = WORKLOADS[cfg.workload]
n, m, V = 4, 256, wl.vocab
bw = DEFAULT_BANDWIDTHS(n)
t = torch.tensor(transmission_time_codec(
    cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, None)),
    dtype=torch.float32, device=dev)
decide, advance, _, out_rows = make_dlrm_esd_stages(
    n, m, t, 1.0, exchange="ragged", capacity=int(0.2 * V))
state = esd_sparse_init(n, V, int(0.2 * V), max_ids=out_rows * wl.width,
                        device=dev)
stream = wl.stream(1, n * m)
ms = []
for _ in range(10):
    s, d, l = next(stream)
    s = torch.as_tensor(s.astype(np.int32), device=dev)
    d, l = torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assign, _ = decide(state, s)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    _, state, _ = advance(state, s, d, l, assign)
print(f"[ab] decide ms a step {[round(x, 2) for x in ms]}, mean of steps "
      f"1-9 {statistics.mean(ms[1:]):.3f}")
rng = np.random.default_rng(19)
war = np.round(rng.random((256, 8)) * 10_000).astype(np.float32)
war[:, 4:] = war[:, :4]
cost = torch.as_tensor(war, device=dev)
auction_solve(cost, 32, eps=1 / 257, max_rounds=50)        # warm
torch.cuda.synchronize()
t0 = time.perf_counter()
_, rounds = auction_solve(cost, 32, eps=1 / 257, max_rounds=3000)
torch.cuda.synchronize()
dt = time.perf_counter() - t0
print(f"[ab] S1 price war: {rounds} rounds in {dt * 1e3:.2f} ms, "
      f"{dt / rounds * 1e6:.3f} us a round (host clock)")
'''


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
    rc = 0
    for name in args.order:
        print(f"===== {name}: {trees[name]}", flush=True)
        out = subprocess.run([sys.executable, "-c", SNIPPET],
                             cwd=trees[name], capture_output=True, text=True,
                             timeout=900)
        for ln in out.stdout.splitlines():
            if ln.startswith(("[kernel]", "[ab]")):
                print(ln, flush=True)
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
