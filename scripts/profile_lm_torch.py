"""Profile the PyTorch port's LM training step on one CUDA card.

    python3 scripts/profile_lm_torch.py [--arch smollm-360m] [--batch 4] \
        [--seq-len 2048] [--steps 6] [--warm 3] [--layers N]

Builds the step as ``repro_torch.launch.train.run_lm`` does (full width
and depth, or ``--layers`` of them, bf16, Adam at lr 1e-2, random
weights from ``--seed``; the VLM and audio families on
``api.make_train_batch``'s batches of ``--seq-len``: pixtral's patches
count in it, whisper's frames are it), runs ``--warm`` steps
unprofiled, then
profiles the rest with ``torch.profiler`` (CPU and CUDA activity), the
forward (loss), the backward and the optimizer each inside a
``record_function`` range.
Prints, per phase, the host time (after a synchronise) of the
unprofiled steps after the first and of the profiled ones, and the time
in which the device ran any of its kernels (the union of kernel
intervals inside the phase's host span: each phase ends with a
synchronise, and autograd launches the backward's kernels from a thread
of its own, outside the range's device-side span); the same share over
the whole profiled window; the device time a step of the flash kernel
B8's forward, of its backward kernel beside it, of the linear-scan
kernels (the SSM and hybrid LMs' recurrence) and of the matrix products
(cuBLAS's ``nvjet`` kernels among them); and the kernels that took most
device time.  For the audio family also the encoder's attention core
(the naive route: logits, softmax and the product with v, forward and
backward, every encoder layer) timed alone with CUDA events beside B8
non-causal at the same shape, and their share of the step.  Writes the
table to ``--out`` when given.  Needs a CUDA device; exits non-zero without
one.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from profile_train_torch import _union_us

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("forward", "backward", "optimizer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lm_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import api
    from repro_torch.optim import adam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = api.init_model(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(args.seed), device=dev)
    params = list(model.parameters())
    opt = adam(1e-2)
    opt_state = opt.init(params)
    stream = token_stream(args.seed, cfg.vocab, args.batch, args.seq_len + 1)
    rng = np.random.default_rng(args.seed)
    host = {p: [] for p in PHASES}      # per step, unprofiled and not

    def next_batch():
        if cfg.family in ("vlm", "audio"):
            return {k: torch.as_tensor(v, device=dev) for k, v in
                    api.make_train_batch(rng, cfg, args.batch,
                                         args.seq_len).items()}
        tok = torch.as_tensor(next(stream), device=dev)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def step():
        nonlocal opt_state
        batch = next_batch()
        for name in PHASES:
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                if name == "forward":
                    loss = api.train_loss(model, cfg, batch, remat=False)
                elif name == "backward":
                    grads = list(torch.autograd.grad(loss, params))
                else:
                    new, opt_state = opt.update(grads, opt_state, params)
                    with torch.no_grad():
                        for p, q in zip(params, new):
                            p.copy_(q)
                    del new, grads
                torch.cuda.synchronize()
            host[name].append(time.perf_counter() - t0)
        return float(loss.detach())

    for _ in range(args.warm):
        step()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        losses = [step() for _ in range(args.warm, args.steps)]
        wall_us = (time.perf_counter() - t0) * 1e6

    n_prof = args.steps - args.warm
    lines = [smi, f"[profile] {cfg.name} ({cfg.n_layers} layers), B "
             f"{args.batch}, S {args.seq_len}, "
             f"{cfg.dtype}, steps {args.warm}..{args.steps - 1} profiled, "
             f"losses {losses}"]
    events = prof.events()
    spans = {p: [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == p
                 and e.device_type == torch.autograd.DeviceType.CPU]
             for p in PHASES}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in PHASES]
    iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    for name in PHASES:
        clipped = [(max(a, s0), min(b, s1)) for s0, s1 in spans[name]
                   for a, b in iv if a < s1 and b > s0]
        dev_ms = _union_us(clipped) / 1e3 / n_prof
        quiet_ms = float(np.mean(host[name][1:args.warm])) * 1e3
        host_ms = float(np.mean(host[name][args.warm:])) * 1e3
        n_k = sum(s0 <= a < s1 for s0, s1 in spans[name] for a, _ in iv)
        lines.append(f"[profile] {name}: host {quiet_ms:.3f} ms/step "
                     f"unprofiled (steps 1..{args.warm - 1}), {host_ms:.3f} "
                     f"profiled; device busy {dev_ms:.3f} ms/step "
                     f"({dev_ms / host_ms:.1%} of the profiled host time); "
                     f"{n_k / n_prof:.0f} kernels/step")
    busy = _union_us(iv)
    lines.append(f"[profile] window {wall_us / 1e3:.1f} ms, device busy "
                 f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), idle "
                 f"{1 - busy / wall_us:.1%}; {len(kernels)} kernels "
                 f"({len(kernels) / n_prof:.0f} per step)")
    by_kernel = {}
    for e in kernels:
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    total_us = max(sum(us for _, us in by_kernel.values()), 1e-9)
    for label, pick in (
            ("flash kernel B8 (forward)",
             lambda n: "flash_attention_wgmma_kernel" in n
             or "flash_attention_kernel" in n),
            ("B8's backward kernel (D, dK/dV, dQ)",
             lambda n: "flash_bwd_" in n),
            ("linear-scan kernels (forward, backward)",
             lambda n: "linear_scan" in n),
            ("matrix products", lambda n: "flash" not in n and any(
                w in n.lower() for w in ("gemm", "cutlass", "xmma",
                                         "sm90", "nvjet")))):
        us = sum(v[1] for n, v in by_kernel.items() if pick(n))
        cnt = sum(v[0] for n, v in by_kernel.items() if pick(n))
        lines.append(f"[profile] {label}: {us / 1e3 / n_prof:.3f} ms/step "
                     f"({us / total_us:.1%} of kernel time), "
                     f"{cnt / n_prof:.1f} launches/step")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:20]
    for name, (cnt, us) in top:
        lines.append(f"[profile] kernel {us / 1e3 / n_prof:9.3f} ms/step "
                     f"{cnt / n_prof:8.1f} launches/step  {name[:110]}")
    lines.append(f"[profile] peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                 f"(profiled steps)")
    if cfg.family == "audio":
        step_ms = float(np.mean([sum(h) for h in zip(
            *(host[p][1:args.warm] for p in PHASES))])) * 1e3
        lines += _encoder_attention(cfg, args.batch, args.seq_len, step_ms)
    text = "\n".join(lines)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


def _events_ms(fn, reps: int = 10) -> float:
    """Median ms of ``fn`` between CUDA events, after 2 warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def _encoder_attention(cfg, B: int, T: int, step_ms: float) -> list:
    """The audio encoder's attention core at (B, T) frames, forward and
    backward, on the naive route it takes and on B8 non-causal."""
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.models.layers import attention_naive

    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16).requires_grad_()
               for shape in ((B, T, KV, G, hd), (B, T, KV, hd),
                             (B, T, KV, hd)))
    dout = torch.randn((B, T, KV, G, hd), generator=g,
                       device="cuda").to(torch.bfloat16)
    pos = torch.arange(T, device="cuda")
    routes = {"naive": lambda: attention_naive(q, k, v, "full", 0, pos, pos,
                                               bidirectional=True),
              "B8 non-causal": lambda: flash_attn(q, k, v, causal=False)}
    lines = []
    for name, fn in routes.items():
        ms = _events_ms(lambda: torch.autograd.grad(fn(), (q, k, v), dout))
        total = ms * cfg.encoder_layers
        lines.append(f"[profile] encoder attention core, {name}: B {B}, T "
                     f"{T}, {KV * G} heads, hd {hd}, bf16, forward and "
                     f"backward {ms:.3f} ms a layer, {total:.1f} ms a step "
                     f"({cfg.encoder_layers} layers; {total / step_ms:.1%} "
                     f"of the {step_ms:.1f} ms unprofiled step)")
    return lines


if __name__ == "__main__":
    sys.exit(main())
