"""B8's forward and backward on the card, broken down by kernel.

    python3 scripts/profile_flash_torch.py [--dtype float32] [--reps 10]

For each of ``chip_smoke.py`` phase 3's shapes (the LM path's, non-causal,
hd 128 at B 2, phi3.5-moe's and pixtral-12b's training shape, pixtral's
prefill, hd 32) draws q, k, v and dout, runs ``flash_attention`` and
``flash_attention_backward`` ``--reps`` times under ``torch.profiler``
and prints each CUDA kernel's launches a call and device ms a launch:
for the f32 route the split pass (``tf32_split_kernel``, two launches a
forward and four a backward), the forward kernel and the backward's
dK/dV and dQ passes.  Prints the card's name and power limit first.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(4, 2048, 5, 3, 64, True), (2, 1024, 5, 3, 64, False),
          (2, 2048, 2, 4, 128, True), (1, 2048, 8, 4, 128, True),
          (4, 2048, 8, 4, 128, True), (2, 2048, 4, 2, 32, True)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash_torch: no CUDA device")
    from repro_torch.kernels import flash_attn as FA

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dtype = getattr(torch, args.dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, KV, G, hd, causal in SHAPES:
        q = torch.randn((B, S, KV, G, hd), generator=g, device="cuda")
        k, v = (torch.randn((B, S, KV, hd), generator=g, device="cuda")
                for _ in range(2))
        dout = torch.randn(q.shape, generator=g, device="cuda")
        q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
        out, lse = FA.flash_attention(q, k, v, causal)

        def call():
            FA.flash_attention(q, k, v, causal)
            FA.flash_attention_backward(q, k, v, out, lse, dout, causal)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        print(f"B={B} S={S} KV={KV} G={G} hd={hd} "
              f"{'causal' if causal else 'full'} {args.dtype}, forward and "
              f"backward:")
        for ev in sorted(prof.key_averages(), key=lambda e: e.key):
            if ev.device_time_total > 0:
                named = re.search(r"(\w+_kernel(<[^>]*>)?)", ev.key)
                name = named[1] if named else ev.key[:64]
                print(f"  {name:64s} "
                      f"{ev.count / args.reps:4.1f} a call, "
                      f"{ev.device_time_total / ev.count / 1e3:.4f} ms a "
                      f"launch")
        del q, k, v, dout, out, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
