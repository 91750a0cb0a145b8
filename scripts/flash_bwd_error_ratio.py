"""Error of B8's bf16 backward kernel beside SDPA's backward, per seed.

    python3 scripts/flash_bwd_error_ratio.py [--seeds 8] [--out FILE]

For each shape (B, Sq = Sk, KV, G, hd, causal) and each seed 0 .. seeds-1
(plus the seed ``tests/test_torch_cuda_kernels.py`` gives the shape),
draws bf16 q, k, v and dout, runs ``flash_attention`` and the backward
kernel (``flash_attention_backward``), and the autograd gradients of
``scaled_dot_product_attention(enable_gqa=True)`` on the (B, H, S, hd)
layout, and holds both against the plain ``flash_attention_bwd``
evaluated in f32 on the same values.  Prints, for dq, dk and dv, the
ratio of the kernel's max abs error to SDPA's and of the mean abs errors,
and the worst of each per shape.  Writes the rows as JSON to ``--out``
when given.  Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the bf16 shapes of the card test, then larger ragged ones
SHAPES = [
    (2, 300, 5, 3, 64, True),
    (1, 300, 2, 1, 32, False),
    (1, 256, 2, 4, 128, True),
    (1, 192, 1, 2, 64, False),
    (2, 1000, 5, 3, 64, True),
    (2, 1000, 2, 1, 32, False),
    (2, 1000, 2, 4, 128, True),
    (2, 1000, 2, 2, 64, False),
]


def _sdpa(q, k, v, causal):
    B, S, KV, G, hd = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, S, KV * G, hd).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    return out.transpose(1, 2).reshape(B, S, KV, G, hd)


def ratios(shape, seed: int) -> dict:
    from repro_torch.kernels import flash_attn as tf

    B, S, KV, G, hd, causal = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, KV, G, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    out, lse = tf.flash_attention(q, k, v, causal)
    dout = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
    got = tf.flash_attention_backward(q, k, v, out, lse, dout, causal)
    want = tf.flash_attention_bwd(q.float(), k.float(), v.float(),
                                  out.float(), lse, dout.float(), causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.autograd.grad(_sdpa(*leaves, causal), leaves, dout)
    row = {}
    for name, a, b, s in zip("qkv", got, want, sdpa):
        d, ds = (a.float() - b).abs(), (s.float() - b).abs()
        row[f"d{name}_max"] = float(d.max()) / float(ds.max())
        row[f"d{name}_mean"] = float(d.mean()) / float(ds.mean())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_error_ratio: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rows = []
    for shape in SHAPES:
        B, S, KV, G, hd, causal = shape
        test_seed = S + hd + int(causal)
        per = []
        for seed in [*range(args.seeds), test_seed]:
            r = ratios(shape, seed)
            per.append(r)
            rows.append({"shape": shape, "seed": seed, **r})
            print(f"B {B} S {S} KV {KV} G {G} hd {hd} causal {causal} "
                  f"seed {seed}: " + ", ".join(
                      f"{k} {x:.3f}" for k, x in r.items()))
        worst_max = max(max(r[f"d{n}_max"] for n in "qkv") for r in per)
        worst_mean = max(max(r[f"d{n}_mean"] for n in "qkv") for r in per)
        print(f"  worst over seeds: max ratio {worst_max:.3f}, mean ratio "
              f"{worst_mean:.3f}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
