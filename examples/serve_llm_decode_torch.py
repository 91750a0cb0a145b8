"""Serve an LM with batched requests on PyTorch: the KV-cache decode loop.

  PYTHONPATH=src python examples/serve_llm_decode_torch.py \
      [--arch smollm-360m] [--device cpu]

The port's counterpart of ``examples/serve_llm_decode.py``: the reduced
(smoke) variant of an LM architecture (dense, MoE, SSM such as
``falcon-mamba-7b`` or hybrid such as ``recurrentgemma-2b``, whose
recurrent layers decode from an O(1) state; a VLM decodes its text
tokens; ``whisper-large-v3``'s decoder decodes over zero cross K/V of
``enc_len = prompt_len + gen_len`` frames, as the reference's example
does) with random weights from seed 0, a batch of seeded prompts fed
token by token into the cache (teacher-forced), then greedy
continuations, through ``launch.steps.make_serve_step``.  ``--device``
defaults to ``cuda`` and raises without a card.  ``run(args, cfg=,
model=, prompts=, cache=)`` takes another configuration (a full-width
one), weights, prompts and decode cache.

Each step ends with its token on the device and, on a card, a
synchronise, so the per-step wall histogram (p50/p99) counts the
device's work; progress prints as stable-key-order ``log_step`` lines,
as the training and serving drivers print.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.obs import MetricsRegistry, log_step  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu is for tests; cuda raises without a GPU")
    return ap


def run(args, cfg=None, model=None, prompts=None, on_logits=None,
        cache=None) -> dict:
    """Decode ``prompt_len + gen_len - 1`` steps; returns the summary:
    tokens/s, step p50/p99 ms and the (batch, prompt_len + gen_len)
    token sequences.  ``cfg`` replaces ``--arch``'s smoke config,
    ``model`` the seeded weights, ``prompts`` (batch, prompt_len) the
    seeded prompts, ``cache`` the empty decode cache (whisper's with its
    cross K/V filled from an encoding); ``on_logits(pos, logits)`` sees
    each step's logits (B, 1, V) on the device."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, smoke=True)
    rng = np.random.default_rng(0)
    if model is None:
        model = api.init_model(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
    max_len = args.prompt_len + args.gen_len
    if cache is None:
        cache = api.init_decode_cache(cfg, args.batch, max_len, device)
    step = make_serve_step(cfg)

    if prompts is None:
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    prompts = torch.as_tensor(np.asarray(prompts), device=device)
    tok = prompts[:, :1]
    reg = MetricsRegistry()
    step_h = reg.histogram("decode.step_s", keep=True)
    tok_c = reg.counter("decode.tokens")
    t0 = time.perf_counter()
    out_tokens = [tok]
    for pos in range(max_len - 1):
        ts = time.perf_counter()
        logits, cache = step(model, cache, tok, pos)
        if on_logits is not None:
            on_logits(pos, logits)
        if pos + 1 < args.prompt_len:            # teacher-forced prefill
            tok = prompts[:, pos + 1:pos + 2]
        else:                                     # greedy decode
            tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens.append(tok)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_h.observe(time.perf_counter() - ts)
        tok_c.inc(args.batch)
        if pos % 8 == 0 or pos == max_len - 2:
            log_step({"step": pos, "wall_s": round(time.perf_counter() - t0, 4),
                      "phase": "prefill" if pos + 1 < args.prompt_len
                               else "decode",
                      "step_ms": round((time.perf_counter() - ts) * 1e3, 2)},
                     stream=sys.stdout)
    dt = time.perf_counter() - t0
    seq = torch.cat(out_tokens, dim=1).cpu().numpy()
    summary = {"wall_s": round(dt, 4), "arch": cfg.name,
               "device": str(device), "batch": args.batch,
               "steps": max_len - 1,
               "tok_per_s": tok_c.value / dt,
               "step_p50_ms": step_h.quantile(0.5) * 1e3,
               "step_p99_ms": step_h.quantile(0.99) * 1e3}
    log_step(summary, stream=sys.stdout)
    summary["sequences"] = seq
    return summary


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run(args)
    seq = out["sequences"]
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}] prompt={seq[b, :args.prompt_len].tolist()} "
              f"-> gen={seq[b, args.prompt_len:].tolist()}")
    return out


if __name__ == "__main__":
    main()
