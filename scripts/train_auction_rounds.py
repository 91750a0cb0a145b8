"""Rounds of the training step's auction, step by step.

    PYTHONPATH=src python scripts/train_auction_rounds.py [--arch wdl-s1] \
        [--workers 4] [--batch-per-worker 256] [--steps 10] \
        [--capacity-ratio 0.2] [--codec int8] [--device cpu]

Runs the decide and advance stages of ``repro_torch.launch.train.
run_dlrm`` (ESD alpha 1, ragged exchange, the same seeded stream and
link times; ``chip_smoke.py`` phase 6's configuration by default) and
prints, for every step, the rounds each worker's auction took in its
nine phases' sum, and their phases.  The decisions never read the
model, so the train stage is left out and no embedding table is built:
the rounds are those of the driver's run, on any device (the plain
version on the CPU, the fused auction kernel on the card).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="wdl-s1")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch-per-worker", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--capacity-ratio", type=float, default=0.2)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.dispatch import esd_sparse_init
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.device import resolve_device
    from repro_torch.kernels import auction as A
    from repro_torch.launch.steps import make_dlrm_esd_stages
    from repro_torch.quant.codecs import get_codec, resolve_link_codecs

    dev = resolve_device(args.device)
    cfg = DLRM_CONFIGS[args.arch]
    wl = WORKLOADS[cfg.workload]
    n, m, V = args.workers, args.batch_per_worker, wl.vocab
    capacity = int(args.capacity_ratio * V)
    capacity = capacity if capacity < V else None
    codec = get_codec(args.codec)
    bw = DEFAULT_BANDWIDTHS(n)
    t_tran = torch.tensor(transmission_time_codec(
        cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, codec)),
        dtype=torch.float32, device=dev)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        n, m, t_tran, 1.0, exchange="ragged", capacity=capacity, codec=codec)
    state = esd_sparse_init(n, V, capacity, max_ids=out_rows * wl.width,
                            device=dev)
    stream = wl.stream(args.seed + 1, n * m)
    per_step = []
    for i in range(args.steps):
        s, d, l = next(stream)
        s = torch.as_tensor(s.astype(np.int32), device=dev)
        d, l = torch.as_tensor(d, device=dev), torch.as_tensor(l, device=dev)
        A.ROUNDS_LOG = []
        assign, _ = decide(state, s)
        _, state, _ = advance(state, s, d, l, assign)
        (rounds,) = A.ROUNDS_LOG
        per_step.append(rounds.cpu().tolist())
        print(f"step {i}: rounds per worker {rounds.sum(dim=1).tolist()}, "
              f"by phase {per_step[-1]}", flush=True)
    A.ROUNDS_LOG = None
    print(json.dumps({"arch": args.arch, "codec": args.codec,
                      "device": str(dev), "rounds": per_step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
