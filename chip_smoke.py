"""Drive the PyTorch port's serving path and training step, exact and
over the quantized wire, the paper's simulator with its auction solver,
LM training with its flash-attention kernel, and the pipelined training
step with its prefetch plane, on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and ``nvidia-smi``'s name and power limit;
2. build — compiles the CUDA sources in ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all at once, and prints each kernel's
   registers and spills; counts the tensor-core instructions in the SASS
   of B8's libraries (``cuobjdump -sass``): ``HGMMA`` in the forward's
   ``flash_attn_sm90``, ``HGMMA`` or ``HMMA`` in the backward's
   ``flash_attn_bwd``, and fails on none;
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its median time, the plain version's, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over 67 TFLOP/s f32), beside the launch floor (an empty kernel's
   device and call ms).  Serving (wdl-s1: V = 502,000, E = 512): the
   hot-set plane of C rows (and the training prefetch plane's pull: 64
   of 512 slots), bags of the stream's 48 history slots, B =
   16 and 4,096, bit for bit (and with an all-PAD bag, weights, and at
   E = 510).  Training: the decide stage's per-id cost table (U, 4)
   pooled over one S1 batch of 256 x 74 (and the pooled lookup again at
   E = 512 on the wdl-s1 table), the row pack alone on 256 slots of ids
   (74 int32), dense features (13 f32) and labels (1 f32), and the
   exchange's one-launch pack of all three for 4 workers of 256, bit for
   bit against its per-worker plain version (balanced, with overflow,
   with an empty destination, on a relaxed budget), timed beside the 12
   row packs it replaces and beside those with their slot maps.  The
   quantized wire: the pack-quantize alone on 256 slots of dense features
   (fp16, int8, int4, int8:4; and int8 at 512 columns); the exchange's
   one launch with the dense features quantized
   (``pack_send_all_quant``: fp16, int8, int4, int8:4 at the training
   shapes, balanced and with overflow, and int8 at 512 columns), bit for
   bit against its per-worker plain version, timed beside the path it
   replaced (the exact pack, 4 pack-quantizes and their stack); and the
   pooled lookup over the int8-quantized wdl-s1 table (256 x 74, E = 512
   and E = 4; both of its layouts).
   The auction's bids at Table 2's and the simulator's shapes (k = 256
   and 8,192 rows of 8 workers, 1,024 of 16, 64 of 1; a random
   unassigned mask), bit for bit; and the fused whole-solve auction
   kernel at the training step's decide (4 auctions of 256 x 4), the
   simulator's S1 decisions (an exact grid, and a price war cut at 6,000
   rounds) and Table 2's largest, bit for bit in assignment, slot prices
   and owners and rounds, with its ms a solve and us a round.  The flash
   attention at the LM path's
   shape (smollm-360m: B = 4, S = 2,048, 5 KV heads x 3, hd = 64,
   causal) and around it (non-causal, hd 128, hd 32): bf16 on the
   ``wgmma`` kernel (max abs err 1e-2, or up to 2e-2 where it is within
   1.5x ``scaled_dot_product_attention``'s error against the same plain
   version: both round P to bf16; lse 2e-5), and f32 on the CUDA-core
   kernel (2e-5); its backward kernel against the plain backward (evaluated in
   f32) in bf16 (each gradient within 1.5x the error of SDPA's backward
   against it) and f32 (1e-4), timed beside the plain backward and SDPA's
   backward; and the
   gradients of its autograd Function against autograd of its plain
   version (1e-4); SDPA timed as the library yardstick, the bound at 989
   TFLOP/s bf16 (67 f32) and each kernel's TFLOP/s;
4. parity — the serve step and a TTL refresh, and 3 steps of the training
   stages, exact and with ``--codec int8``, on the card against the same
   calls on the CPU at wdl-tiny; the simulator with ``opt="auction"``
   (tiny workload, 4 workers on distinct links, 4 iterations) and the
   serving simulator (S1, 8 workers, 0.5 s) on the card against the CPU;
   3 steps of ``run_lm`` at smollm-360m's smoke config with S = 2,048
   (the flash route) on the card against the CPU, losses within 1e-4,
   and again in bf16 (the card's wgmma forward and tensor-core backward
   against the CPU's plain versions), losses within 5e-2; ``run_dlrm``
   pipelined at wdl-tiny (depth 2; depth 2 with stale decisions; depth 3
   with decide-ahead 2, lookahead 2 and 16 rows a step prefetched into
   64 slots), the card's chain on a stream of its own, against the CPU:
   integer fields equal, losses and Alg.-1 costs within 1e-5, the final
   prefetch plane's ids, expiry and rows equal;
5. serve — ``run_serve`` at wdl-s1 (4 workers, 2,000 QPS for 1 s), then
   for 0.5 s with ``--codec int8``;
6. train — ``run_dlrm`` at wdl-s1 (4 workers x 256 samples, ESD alpha 1,
   ragged exchange, 10 steps), then again with ``--codec int8``: one
   launch of the fused auction kernel a step, its rounds per step equal
   to the CPU's; one launch of the exchange's pack a step (with the codec
   its quantized kernel), the row pack and the pack-quantize alone
   never;
7. table 2 — ``auction_dispatch(exact=False)`` on the draws of
   ``benchmarks/table2.py`` (8 workers, 32 to 1,024 samples a worker):
   rounds, ms per decision and one auction_solve launch each, beside the
   paper's CUDA-Hungarian ms; assignments and rounds equal to the CPU's;
8. simulate — ``simulate`` at S1 (8 workers, 4 x 5 and 4 x 0.5 Gbps,
   r = 0.08, E = 512, 32 samples a worker, 8 iterations, 2 of warm-up;
   the paper's 60 iterations and 128 a worker cut): ESD alpha 1 with the
   auction (calibrated decisions: rounds, cost, ItpS and hit ratio equal
   to the CPU's) and with SSP, LAIA, HET, FAE and random; then the
   serving simulator with the auction;
9. lm-train — ``run_lm`` at smollm-360m's full width and depth (32
   layers, d = 960, vocab 49,152, bf16), B = 4, S = 2,048, 5 steps of
   Adam: ms per step (mean of steps 1-4, each ended by a synchronise),
   tokens/s, losses, peak memory, and 32 launches a step of the flash
   kernel and 32 of its backward kernel;
10. train-pipeline — ``run_dlrm`` at phase 6's configuration with
   ``--pipeline-depth 2``, exact and with ``--codec int8``: every record
   (loss, counts, cost, Alg.-1 estimate) bit for bit phase 6's, the
   auction's rounds and the launches a step depth 1's, the wall ms a
   step beside depth 1's; with ``--stale-decide`` (step 0's
   ``alg1_realized`` equal to its ``alg1_est`` within 1e-6); and the
   README's configuration (depth 4, lookahead 4, decide-ahead 3, 64 rows
   a step prefetched into 512 slots): one staged_gather launch a step,
   rows prefetched after step 0, demand misses within the misses.

Each run of phases 5 to 10 sets every kernel's launch counter to 0 just
before and reads the counters just after.  Then one JSON line of kernel
records, after the script's wall time, and as the last line ``{"ok":
true, "device": {...}}``.  Any failed check raises, so the script exits
non-zero; it also fails without a CUDA device and when the package is
not beside it.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"pooled_lookup": CSRC + "emb_lookup.cu",
           "pack_send_all": CSRC + "exchange_pack.cu",
           "gather_rows": CSRC + "exchange_pack.cu",
           "staged_gather": CSRC + "emb_lookup.cu",
           "pooled_lookup_staged": CSRC + "emb_lookup.cu",
           "gather_rows_quant": CSRC + "exchange_pack.cu",
           "pack_send_all_quant": CSRC + "exchange_pack.cu",
           "pooled_lookup_quant": CSRC + "emb_lookup.cu",
           "auction_bids": CSRC + "auction.cu",
           "auction_solve": CSRC + "auction.cu",
           "flash_attention": CSRC + "flash_attn_sm90.cu",
           "flash_attention_bwd": CSRC + "flash_attn_bwd.cu"}
REPLACES = {"pooled_lookup": "src/repro/kernels/emb_lookup.py:88",
            "pack_send_all": "src/repro/kernels/exchange_pack.py:34 with "
                             "the slot map around it: "
                             "src/repro/exchange/ragged.py:36 (pack_send)",
            "gather_rows": "src/repro/kernels/exchange_pack.py:34",
            "staged_gather": "src/repro/kernels/emb_lookup.py:174",
            "pooled_lookup_staged": "src/repro/kernels/emb_lookup.py:245",
            "gather_rows_quant": "src/repro/kernels/exchange_pack.py:108",
            "pack_send_all_quant": "src/repro/kernels/exchange_pack.py:108 "
                                   "and :34 with the slot map around them: "
                                   "src/repro/exchange/ragged.py:123 "
                                   "(ragged_exchange_quant), :36 "
                                   "(pack_send)",
            "pooled_lookup_quant": "src/repro/kernels/emb_lookup.py:337",
            "auction_bids": "src/repro/kernels/auction.py:51",
            "auction_solve": "src/repro/kernels/auction.py:51 with the "
                             "loops around it: src/repro/core/auction.py:34 "
                             "(_round_body), :95 (_auction_phase); "
                             "src/repro/kernels/ops.py:70 (_resolve), :100 "
                             "(_phase); src/repro/core/dispatch_tpu.py:158 "
                             "(auction_fixed)",
            "flash_attention": "src/repro/kernels/flash_attn.py:66",
            "flash_attention_bwd": "the gradient of src/repro/kernels/"
                                   "flash_attn.py:66 (JAX differentiates "
                                   "src/repro/models/layers.py:141)"}
LM_ARGV = ["--arch", "smollm-360m", "--seq-len", "2048",
           "--batch-per-worker", "4", "--steps", "5", "--device", "cuda"]
TRAIN_ARGV = ["--arch", "wdl-s1", "--workers", "4", "--batch-per-worker",
              "256", "--steps", "10", "--esd-alpha", "1", "--exchange",
              "ragged", "--capacity-ratio", "0.2", "--device", "cuda"]
# the training auction's rounds per step and worker at TRAIN_ARGV, seed 0,
# from the plain version on the CPU (scripts/train_auction_rounds.py
# --device cpu, and --codec int8): step 0 meets a cold cache
TRAIN_ROUNDS = {
    None: [[10390, 10256, 10547, 10663], [2016, 2752, 446, 58],
           [43, 1013, 50, 89], [73, 61, 32, 66], [53, 48, 49, 106],
           [45, 41, 34, 47], [40, 32, 40, 34], [35, 50, 48, 63],
           [63, 62, 64, 52], [53, 234, 31, 44]],
    "int8": [[9951, 10267, 10571, 10633], [48, 50, 2022, 587],
             [45, 79, 737, 44], [101, 41, 57, 99], [45, 36, 46, 56],
             [49, 45, 63, 41], [48, 38, 47, 34], [50, 38, 53, 38],
             [27, 2216, 38, 43], [68, 40, 25, 49]]}


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, reps: int = 50) -> tuple[float, float]:
    """(device ms, call ms): medians over ``reps`` calls timed with CUDA
    events.  For the device time the stream is first held busy with a
    spin longer than the host takes to enqueue the call, so the events
    bracket the device work alone; the call time has no spin and so also
    counts the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(host_s * 4e9) + 200_000          # cycles, at <= 4 GHz
    dev, call = [], []
    for hold, out in ((True, dev), (False, call)):
        pairs = []
        for _ in range(reps):
            if hold:
                torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
            if hold:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        out.extend(s.elapsed_time(e) for s, e in pairs)
    return statistics.median(dev), statistics.median(call)


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[device] {name} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    from repro_torch.kernels import _build

    names = ("emb_lookup", "exchange_pack", "auction", "flash_attn",
             "flash_attn_sm90", "flash_attn_bwd")
    t = time.perf_counter()
    _build.load_libraries(*names)
    dt = time.perf_counter() - t
    print(f"[build] {', '.join(names)} in {dt:.2f} s (in parallel)")
    for name in names:
        # ptxas reports, per kernel: the entry, then its stack and
        # spills, then its registers
        kernel, facts = "?", []
        for ln in _build.build_log(name).splitlines():
            if "Compiling entry function" in ln:
                named = re.search(r"([a-z_]+_kernel)I", ln)
                kernel = named[1] if named else next(
                    (k for k in SOURCES if f"{k}_kernel" in ln),
                    ln.split("'")[1] if "'" in ln else ln)
                # a template instance: element type (wgmma: bf16), hd
                inst = re.search(r"kernelI(f|13__nv_bfloat16)?Li(\d+)E", ln)
                if inst:
                    kernel += (f"<{'f32' if inst[1] == 'f' else 'bf16'}, "
                               f"hd {inst[2]}>")
            elif "spill" in ln or "registers" in ln:
                facts.append(ln.split(":", 1)[-1].strip())
                if "registers" in ln:
                    print(f"[build] {name} {kernel}: " + "; ".join(facts))
                    facts = []
    objdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, ops in (("flash_attn_sm90", ("HGMMA",)),
                      ("flash_attn_bwd", ("HGMMA", "HMMA"))):
        sass = subprocess.run([objdump, "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        print(f"[build] {name} SASS: {counts}")
        check(sum(counts.values()) > 0, f"{name} runs on the tensor cores "
                                        f"({' or '.join(ops)} in its SASS)")


def _launch_counters():
    from repro_torch.kernels import (auction, emb_lookup, exchange_pack,
                                     flash_attn)

    return (emb_lookup.LAUNCHES, exchange_pack.LAUNCHES, auction.LAUNCHES,
            flash_attn.LAUNCHES)


def _zero_launches():
    for counts in _launch_counters():
        for k in counts:
            counts[k] = 0


def _read_launches() -> dict:
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def phase_train_kernels(seed: int) -> dict:
    """B1, B2 and the exchange's one-launch pack at the training step's
    shapes."""
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.kernels.ops import cost_table_sparse

    wl = WORKLOADS["S1"]
    V, n, m = wl.vocab, 4, 256
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    rec = {}

    def pooled(what, table, ids, w):
        out = K.pooled_lookup(table, ids, w)
        ref = K.pooled_lookup_ref(table, ids, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"pooled_lookup {what} is bitwise "
                                     f"equal to plain")
        ms, call_ms = device_ms(lambda: K.pooled_lookup(table, ids, w))
        plain_ms, _ = device_ms(
            lambda: K.pooled_lookup_ref(table, ids, w), reps=20)
        valid = ids >= 0
        ids_c = torch.where(valid, ids, 0).long()
        w_c = torch.where(valid, w, 0.0)
        lib_ms, _ = device_ms(lambda: torch.nn.functional.embedding_bag(
            ids_c, table, mode="sum", per_sample_weights=w_c))
        B, F = ids.shape
        E = table.shape[1]
        rows = int(torch.unique(ids_c).numel())
        b_ms, b_by = bound(rows * E * 4 + 2 * B * F * 4 + B * E * 4,
                           2 * B * F * E)
        print(f"[kernel] pooled_lookup {what} B={B} F={F} E={E} "
              f"rows={rows}: exact, {ms:.4f} ms (call {call_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, embedding_bag {lib_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # the decide stage: Alg. 1's compact (U, 4) cost table from a random
    # cache state, pooled over one S1 batch's remapped ids
    latest = torch.rand((n, V), generator=g, device=dev) < 0.3
    dirty = latest & (torch.rand((n, V), generator=g, device=dev) < 0.5)
    t_tran = torch.tensor((512 * 4.0) / DEFAULT_BANDWIDTHS(n),
                          dtype=torch.float32, device=dev)
    samples = torch.as_tensor(wl.sample_batch(rng, m).astype(np.int32),
                              device=dev)
    table, inv, w = cost_table_sparse(samples, latest, dirty, t_tran)
    rec["pooled_lookup"] = pooled(f"(decide, U={table.shape[0]})", table,
                                  inv, w)
    # the same kernel at E = 512 on the wdl-s1 table
    big = torch.randn((V, 512), generator=g, device=dev) * 0.01
    wts = torch.rand(samples.shape, generator=g, device=dev)
    pooled("(E=512, wdl-s1 table)", big, samples, wts)
    del big

    # the exchange's packs: 256 send slots, about a quarter PAD
    S = m
    slot_np = rng.permutation(m).astype(np.int32)
    slot_np[rng.random(S) < 0.25] = -1
    slot = torch.as_tensor(slot_np, device=dev)
    dense = torch.as_tensor(wl.dense_batch(rng, m), device=dev)
    labels = torch.as_tensor(wl.label_batch(rng, m)[:, None], device=dev)
    for what, rows in (("ids int32", samples), ("dense f32", dense),
                       ("labels f32", labels)):
        out = P.gather_rows(rows, slot)
        ref = P.gather_rows_ref(rows, slot)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"gather_rows {what} is exact")
        check(bool((out[slot < 0] == -1).all()), f"gather_rows {what} "
                                                 f"fills -1 in its dtype")
        ms, call_ms = device_ms(lambda: P.gather_rows(rows, slot))
        plain_ms, _ = device_ms(lambda: P.gather_rows_ref(rows, slot))
        ext = torch.cat([rows, torch.full_like(rows[:1], -1)])
        idx = torch.where(slot >= 0, slot, m).long()
        lib_ms, _ = device_ms(lambda: torch.index_select(ext, 0, idx))
        F = rows.shape[1]
        n_valid = int((slot >= 0).sum())
        b_ms, b_by = bound(S * F * 4 + n_valid * F * 4 + S * 4, 0)
        print(f"[kernel] gather_rows {what} S={S} F={F} valid={n_valid}: "
              f"exact, {ms:.4f} ms (call {call_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        if what == "ids int32":
            rec["gather_rows"] = dict(max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=b_ms, bound_by=b_by)
    rec["pack_send_all"] = phase_pack(rng, wl, n, m, dev)
    return rec


def phase_pack(rng, wl, n: int, m: int, dev) -> dict:
    """The exchange's one-launch pack at the training step's shapes (4
    workers of 256: ids 74 int32, dense 13 f32, labels f32) against its
    plain version, which packs worker by worker; timed beside the 12
    row packs it replaces (given their slot maps) and beside those packs
    with the 12 slot maps the advance built before them."""
    from repro_torch.core.dispatch import dispatch_cap, exchange_budget
    from repro_torch.kernels import exchange_pack as P

    payloads = [
        torch.as_tensor(np.stack([wl.sample_batch(rng, m)
                                  for _ in range(n)]).astype(np.int32),
                        device=dev),
        torch.as_tensor(np.stack([wl.dense_batch(rng, m) for _ in range(n)]),
                        device=dev),
        torch.as_tensor(np.stack([wl.label_batch(rng, m) for _ in range(n)]),
                        device=dev)]
    balanced = np.stack([rng.permutation(np.repeat(np.arange(n), m // n))
                         for _ in range(n)])
    skew = rng.integers(0, n, (n, m))
    skew[:, : m // 2] = 0                  # worker 0 over its budget
    empty = rng.integers(0, n - 1, (n, m))     # nobody sends to the last
    # --cap-slack 0.5: groups of up to 96 rows on blocks of 128
    slack = exchange_budget(dispatch_cap(m, n, 0.5), m)
    uneven = np.stack([rng.permutation(np.repeat(
        np.arange(n), [m * 3 // 8, m // 4, m // 4, m // 8]))
        for _ in range(n)])
    cases = (("train", balanced, m // n), ("overflow", skew, m // n),
             ("empty destination", empty, slack),
             (f"relaxed budget {slack}", uneven, slack))
    for what, a_np, budget in cases:
        assign = torch.as_tensor(a_np.astype(np.int32), device=dev)
        got = P.pack_send_all(assign, payloads, n, budget)
        want = P.pack_send_all_ref(assign, payloads, n, budget)
        torch.cuda.synchronize()
        for x, y in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"pack_send_all {what} is bitwise equal to plain")
        ov = int(got[3])
        print(f"[kernel] pack_send_all {what}: n={n} m={m} budget={budget}"
              f" overflow={ov}: exact")
        check((ov > 0) == (what == "overflow"),
              f"pack_send_all {what}: overflow only where the budget is "
              f"short")
    assign = torch.as_tensor(balanced.astype(np.int32), device=dev)
    budget = m // n
    ms, call_ms = device_ms(lambda: P.pack_send_all(assign, payloads, n,
                                                    budget))
    plain_ms, plain_call = device_ms(
        lambda: P.pack_send_all_ref(assign, payloads, n, budget), reps=20)
    maps = [P.slot_map_ref(assign[i], n, budget)[0] for i in range(n)]

    def packs():
        for rows in payloads:
            for i in range(n):
                P.gather_rows(rows[i].reshape(m, -1), maps[i])

    def packs_and_maps():
        for rows in payloads:
            for i in range(n):
                P.gather_rows(rows[i].reshape(m, -1),
                              P.slot_map_ref(assign[i], n, budget)[0])

    was_ms, was_call = device_ms(packs)
    old_ms, old_call = device_ms(packs_and_maps, reps=20)
    S = n * budget
    words = sum(math.prod(r.shape[2:]) for r in payloads)
    # bytes: assign read, each sent row read once, every slot of every
    # payload written, with slot_to_row and the counts
    b_ms, b_by = bound(n * m * 4 + n * m * words * 4 + n * S * words * 4
                       + n * S * 4 + n * n * 4 + 4, 0)
    print(f"[kernel] pack_send_all train (ids 74 int32, dense 13 f32, "
          f"labels f32): {ms:.4f} ms (call {call_ms:.4f}), plain "
          f"{plain_ms:.4f} ms (call {plain_call:.4f}); the 12 gather_rows "
          f"it replaces {was_ms:.4f} ms (call {was_call:.4f}); with their 12"
          f" slot maps {old_ms:.4f} ms (call {old_call:.4f}); bound "
          f"{b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_quant_kernels(seed: int) -> dict:
    """B4 and B5 at the quantized wire's shapes."""
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.quant.codecs import get_codec, quantize_rows

    wl = WORKLOADS["S1"]
    V, m = wl.vocab, 256
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    rec = {}

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    # B4: one worker's send slots of the dense features, about a quarter
    # PAD; and 512-column rows
    S = m
    slot_np = rng.permutation(m).astype(np.int32)
    slot_np[rng.random(S) < 0.25] = -1
    slot = torch.as_tensor(slot_np, device=dev)
    n_valid = int((slot_np >= 0).sum())
    dense = torch.as_tensor(wl.dense_batch(rng, m), device=dev)
    wide_rows = torch.randn((m, 512), generator=g, device=dev)
    for name, rows in (("fp16", dense), ("int8", dense), ("int4", dense),
                       ("int8:4", dense), ("int8", wide_rows)):
        c = get_codec(name)
        F = rows.shape[1]
        out = P.gather_rows_quant(rows, slot, c)
        ref = P.gather_rows_quant_ref(rows, slot, c)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(out, ref)),
              f"gather_rows_quant {name} F={F} is bitwise equal to plain")
        if c.kind != "fp16":
            check(bool((out[1][slot < 0] == 1).all()
                       and (out[2][slot < 0] == -1).all()
                       and (out[0][slot < 0] == 0).all()),
                  f"gather_rows_quant {name}: PAD slots scale 1, zp -1")
        ms, call_ms = device_ms(lambda: P.gather_rows_quant(rows, slot, c))
        plain_ms, _ = device_ms(
            lambda: P.gather_rows_quant_ref(rows, slot, c), reps=20)
        G = out[1].shape[1]
        code_bytes = 2 if c.kind == "fp16" else 4
        n_bytes = S * 4 + n_valid * F * 4 + S * F * code_bytes + 2 * S * G * 4
        # min, max, subtract, divide, round and two clamps per element
        b_ms, b_by = bound(n_bytes, 0 if c.kind == "fp16" else 7 * S * F)
        print(f"[kernel] gather_rows_quant {name} S={S} F={F} G={G} "
              f"valid={n_valid}: bitwise, {ms:.4f} ms (call {call_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if name == "int8" and F == 13:
            rec["gather_rows_quant"] = dict(
                max_abs_err=float((out[0] - ref[0]).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del wide_rows
    rec["pack_send_all_quant"] = phase_quant_pack(rng, wl, 4, m, dev)

    # B5: one S1 batch pooled over the int8-quantized wdl-s1 table, and
    # over a quantized table at the decide stage's width E = 4
    ids = torch.as_tensor(wl.sample_batch(rng, m).astype(np.int32),
                          device=dev)
    w = torch.rand(ids.shape, generator=g, device=dev)
    valid = ids >= 0
    n_lookups = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    B, F = ids.shape
    for E in (512, 4):
        c = get_codec("int8")
        codes, scale, zp = quantize_rows(
            torch.randn((V, E), generator=g, device=dev) * 0.01, c)
        out = K.pooled_lookup_quant(codes, scale, zp, ids, w, codec=c)
        ref = K.pooled_lookup_quant_ref(codes, scale, zp, ids, w, codec=c)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(same_bits(out, ref), f"pooled_lookup_quant E={E} is bitwise "
                                   f"equal to plain (max err {err})")
        ms, call_ms = device_ms(
            lambda: K.pooled_lookup_quant(codes, scale, zp, ids, w, codec=c))
        plain_ms, _ = device_ms(
            lambda: K.pooled_lookup_quant_ref(codes, scale, zp, ids, w,
                                              codec=c), reps=20)
        G = scale.shape[1]
        n_bytes = rows * (E * 4 + G * 8) + 2 * B * F * 4 + B * E * 4
        # a multiply-add, a multiply and an add per looked-up element
        b_ms, b_by = bound(n_bytes, 4 * n_lookups * E)
        print(f"[kernel] pooled_lookup_quant int8 B={B} F={F} E={E} "
              f"G={G} V={V} rows={rows}: bitwise, {ms:.4f} ms (call "
              f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by})")
        if E == 512:
            rec["pooled_lookup_quant"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
        del codes, scale, zp
    return rec


def phase_quant_pack(rng, wl, n: int, m: int, dev) -> dict:
    """The exchange's one launch with the dense features on the quantized
    wire (4 workers of 256: ids 74 int32, dense 13 f32 quantized, labels
    f32) against its plain version, which packs and quantizes worker by
    worker; timed beside the path it replaced: the exact pack of ids and labels, then a
    pack-quantize a worker on the pack's slot maps, stacked."""
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.quant.codecs import get_codec

    ids = torch.as_tensor(np.stack([wl.sample_batch(rng, m)
                                    for _ in range(n)]).astype(np.int32),
                          device=dev)
    dense = torch.as_tensor(np.stack([wl.dense_batch(rng, m)
                                      for _ in range(n)]), device=dev)
    labels = torch.as_tensor(np.stack([wl.label_batch(rng, m)
                                       for _ in range(n)]), device=dev)
    wide = torch.randn((n, m, 512), device=dev)
    balanced = torch.as_tensor(np.stack(
        [rng.permutation(np.repeat(np.arange(n), m // n))
         for _ in range(n)]).astype(np.int32), device=dev)
    skew = rng.integers(0, n, (n, m))
    skew[:, : m // 2] = 0                  # worker 0 over its budget
    skew = torch.as_tensor(skew.astype(np.int32), device=dev)
    budget = m // n
    marks = (False, True, False)

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    def flat(out):                 # every tensor of an output, but overflow
        return [t for x in out[0] for t in (x if isinstance(x, tuple)
                                            else (x,))] + list(out[1:3])

    cases = [(name, what, a, dense) for name in ("fp16", "int8", "int4",
                                                 "int8:4")
             for what, a in (("train", balanced), ("overflow", skew))]
    for name, what, assign, rows in cases + [("int8", "train", balanced,
                                              wide)]:
        payloads = [ids, rows, labels]
        got = P.pack_send_all(assign, payloads, n, budget, codec=name,
                              quantized=marks)
        want = P.pack_send_all_ref(assign, payloads, n, budget, codec=name,
                                   quantized=marks)
        torch.cuda.synchronize()
        check(all(same_bits(x, y) for x, y in zip(flat(got), flat(want)))
              and int(got[3]) == int(want[3]),
              f"pack_send_all_quant {name} {what} F={rows.shape[2]} is "
              f"bitwise equal to plain")
        check((int(got[3]) > 0) == (what == "overflow"),
              f"pack_send_all_quant {what}: overflow only where the budget "
              f"is short")
        print(f"[kernel] pack_send_all_quant {name} {what}: n={n} m={m} "
              f"budget={budget} F={rows.shape[2]} overflow="
              f"{int(got[3])}: bitwise")
    c = get_codec("int8")
    payloads = [ids, dense, labels]

    def fused():
        P.pack_send_all(balanced, payloads, n, budget, codec=c,
                        quantized=marks)

    def replaced():                # the exact pack, then B4 per worker
        _, stm, _, _ = P.pack_send_all(balanced, [ids, labels], n, budget)
        wire = [P.gather_rows_quant(dense[i], stm[i], c) for i in range(n)]
        return [torch.stack(t) for t in zip(*wire)]

    ms, call_ms = device_ms(fused)
    was_ms, was_call = device_ms(replaced)
    plain_ms, plain_call = device_ms(
        lambda: P.pack_send_all_ref(balanced, payloads, n, budget, codec=c,
                                    quantized=marks), reps=10)
    wide_ms, wide_call = device_ms(lambda: P.pack_send_all(
        balanced, [ids, wide, labels], n, budget, codec=c, quantized=marks))
    S = n * budget
    # bytes: assign read, each row of each payload read once, every slot
    # written (ids 74 words, labels 1, codes 13, scale and zp 1 each),
    # with slot_to_row and the counts; 7 operations a quantized element
    b_ms, b_by = bound(n * m * 4 + n * m * (74 + 13 + 1) * 4
                       + n * S * (74 + 1 + 13 + 2) * 4 + n * S * 4
                       + n * n * 4 + 4, 7 * n * S * 13)
    print(f"[kernel] pack_send_all_quant train (ids 74 int32, dense 13 f32 "
          f"int8, labels f32): {ms:.4f} ms (call {call_ms:.4f}); the path it replaced (pack, 4 gather_rows_quant, stack) "
          f"{was_ms:.4f} ms (call {was_call:.4f}); plain {plain_ms:.4f} ms "
          f"(call {plain_call:.4f}); dense at 512 columns {wide_ms:.4f} ms "
          f"(call {wide_call:.4f}); bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernels(seed: int) -> dict:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.pipeline.prefetch import PrefetchPlane, slot_map
    from repro_torch.serve.sim import _hot_set

    wl = WORKLOADS["S1"]
    V, E, F = wl.vocab, 512, wl.n_fields
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    table = torch.randn((V, E), generator=g, device=dev) * 0.01
    hot = _hot_set(wl, np.random.default_rng(seed + 1), 2048, int(0.25 * V))
    C = len(hot)
    plane_rows = torch.randn((C, E), generator=g, device=dev) * 0.01
    rec = {}

    # staged_gather: the TTL refresh pull, ~1/4 of the slots due
    src_np = np.where(rng.random(C) < 0.25, hot, -1).astype(np.int32)
    src = torch.as_tensor(src_np, device=dev)
    out = K.staged_gather(plane_rows, table, src)
    ref = K.staged_gather_ref(plane_rows, table, src)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), "staged_gather is bitwise equal to plain")
    ms, call_ms = device_ms(lambda: K.staged_gather(plane_rows, table, src))
    plain_ms, plain_call = device_ms(
        lambda: K.staged_gather_ref(plane_rows, table, src))
    b_ms, b_by = bound(2 * C * E * 4 + C * 4, 0)
    rec["staged_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
    print(f"[kernel] staged_gather C={C} E={E} V={V} "
          f"due={int((src_np >= 0).sum())}:"
          f" exact, {ms:.4f} ms (call {call_ms:.4f}), plain {plain_ms:.4f} ms"
          f" (call {plain_call:.4f}), bound {b_ms:.4f} ms ({b_by})")

    # staged_gather at the training prefetch plane (--prefetch 64
    # --prefetch-slots 512): 64 of 512 slots pull a table row
    Cp, pulls = 512, 64
    plane_p = torch.randn((Cp, E), generator=g, device=dev) * 0.01
    src_p = np.full(Cp, -1, np.int32)
    src_p[rng.choice(Cp, pulls, replace=False)] = rng.choice(V, pulls,
                                                             replace=False)
    src_p = torch.as_tensor(src_p, device=dev)
    out = K.staged_gather(plane_p, table, src_p)
    ref = K.staged_gather_ref(plane_p, table, src_p)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "staged_gather at the prefetch plane's "
                                 "shape is bitwise equal to plain")
    ms_p, call_p = device_ms(lambda: K.staged_gather(plane_p, table, src_p))
    plain_p, plain_call_p = device_ms(
        lambda: K.staged_gather_ref(plane_p, table, src_p))
    bp_ms, bp_by = bound(2 * Cp * E * 4 + Cp * 4, 0)
    print(f"[kernel] staged_gather (training prefetch pull) C={Cp} E={E} "
          f"pulled={pulls}: exact, {ms_p:.4f} ms (call {call_p:.4f}), plain "
          f"{plain_p:.4f} ms (call {plain_call_p:.4f}), bound {bp_ms:.4f} ms "
          f"({bp_by})")

    # the launch floor: an empty kernel through the same ctypes path
    from repro_torch.kernels._build import load_library

    lib = load_library("emb_lookup")
    floor_ms, floor_call = device_ms(lambda: lib.empty_launch(
        torch.cuda.current_stream().cuda_stream))
    print(f"[kernel] launch floor (an empty kernel): {floor_ms:.4f} ms "
          f"(call {floor_call:.4f})")

    # pooled_lookup_staged: history bags of the synthetic stream against
    # the hot-set plane, at the serving micro-batch and at a large batch
    plane = PrefetchPlane(ids=torch.as_tensor(hot.astype(np.int32),
                                              device=dev),
                          rows=plane_rows,
                          expiry=torch.full((C,), 1, dtype=torch.int32,
                                            device=dev))
    smap = slot_map(plane, V, 0)

    def bags(B):
        hist = wl.sample_batch(rng, B)[:, F:]
        ids = torch.as_tensor(hist.astype(np.int32), device=dev)
        return ids, torch.where(ids >= 0, smap[ids.long().clamp(min=0)], -1)

    def staged_exact(what, plane_rows, table, slots, ids, w=None):
        out = K.pooled_lookup_staged(plane_rows, table, slots, ids, w)
        ref = K.pooled_lookup_staged_ref(plane_rows, table, slots, ids, w)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"pooled_lookup_staged {what} is bitwise equal to plain")
        return out

    for B in (16, 4096):
        ids, slots = bags(B)
        staged_exact(f"B={B}", plane_rows, table, slots, ids)
        ms, call_ms = device_ms(
            lambda: K.pooled_lookup_staged(plane_rows, table, slots, ids))
        plain_ms, plain_call = device_ms(
            lambda: K.pooled_lookup_staged_ref(plane_rows, table, slots,
                                               ids), reps=20)
        hist, s_np = ids.cpu().numpy(), slots.cpu().numpy()
        valid = hist >= 0
        n_rows = (len(np.unique(s_np[valid & (s_np >= 0)]))
                  + len(np.unique(hist[valid & (s_np < 0)])))
        n_bytes = (n_rows + B) * E * 4 + 2 * B * hist.shape[1] * 4
        b_ms, b_by = bound(n_bytes, 2 * int(valid.sum()) * E)
        print(f"[kernel] pooled_lookup_staged B={B} F={hist.shape[1]} E={E}"
              f" valid={int(valid.sum())} rows={n_rows}: exact,"
              f" {ms:.4f} ms (call {call_ms:.4f}; launch floor "
              f"{floor_ms:.4f}), plain {plain_ms:.4f} ms"
              f" (call {plain_call:.4f}), bound {b_ms:.6f} ms ({b_by})")
        if B == 16:
            rec["pooled_lookup_staged"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
    # around the path: an all-PAD bag, weights, and rows of E = 510 (the
    # scalar layout)
    ids, slots = bags(16)
    ids[3], slots[3] = -1, -1
    w = torch.rand(ids.shape, generator=g, device=dev)
    out = staged_exact("B=16 with an all-PAD bag and weights", plane_rows,
                       table, slots, ids, w)
    check(not out[3].any(), "an all-PAD bag pools to zeros")
    V_odd = 50_000
    odd = torch.randn((V_odd, 510), generator=g, device=dev)
    ids_odd = torch.where(ids >= 0, ids % V_odd, -1)
    staged_exact("E=510 (scalar layout)", odd[:C].contiguous(), odd,
                 slots.clamp(max=C - 1), ids_odd, w)
    print("[kernel] pooled_lookup_staged: exact with an all-PAD bag "
          "(zeros), with weights, and at E = 510")
    return rec


def phase_parity(seed: int):
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.models.dlrm import init_params
    from repro_torch.serve import make_serve_step, refresh_plane, seed_plane

    worst = 0.0
    for arch in ("wdl-tiny", "dfm-tiny", "dcn-tiny"):
        cfg = DLRM_CONFIGS[arch]
        wl = WORKLOADS[cfg.workload]
        cpu = init_params(cfg, wl, torch.Generator().manual_seed(seed), "cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(seed)
        sparse = wl.sample_batch(rng, 8)
        dense = wl.dense_batch(rng, 8)
        ids = np.unique(sparse[sparse >= 0])
        hot = ids[rng.random(ids.size) < 0.6]
        step_fn = make_serve_step(cfg, wl.n_fields)
        pc = seed_plane(cpu.embed, hot, step=0, ttl=4)
        pg = seed_plane(gpu.embed, hot, step=0, ttl=4)
        for step in (0, 6):
            if step:
                pc, nc = refresh_plane(pc, cpu.embed * 1.5, step, ttl=4,
                                       budget=max(1, hot.size // 2))
                pg, ng = refresh_plane(pg, gpu.embed * 1.5, step, ttl=4,
                                       budget=max(1, hot.size // 2))
                check(int(nc) == int(ng), "refresh counts agree")
                for f in ("ids", "rows", "expiry"):
                    check(torch.equal(getattr(pc, f),
                                      getattr(pg, f).cpu()),
                          f"refreshed plane {f} equal on card and CPU")
            lc, qc = step_fn(cpu, pc, sparse, dense, step)
            lg, qg = step_fn(gpu, pg, sparse, dense, step)
            for a, b, what in ((lc, lg, "logits"), (qc, qg, "pooled")):
                b = b.cpu()
                check(bool(torch.isfinite(b).all()), f"{arch} {what} finite")
                check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                      f"{arch} {what} on card vs CPU within 1e-5")
                worst = max(worst, float((a - b).abs().max()))
    print(f"[parity] serve step + refresh, card vs CPU, wdl/dfm/dcn-tiny: "
          f"max abs err {worst:.3g} (tolerance 1e-5)")


def phase_train_parity(seed: int, codec=None):
    """3 steps of the training stages at wdl-tiny (4 workers x 8, ragged
    exchange, alpha 1; exact or over the ``codec`` wire) on the card and
    on the CPU from the same weights: integer outputs and labels equal,
    dense features within 1e-6 (with the codec: dequantized on the
    receiver), losses and parameters within 1e-5."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.dispatch import esd_sparse_init
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.steps import make_dlrm_esd_stages
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.dlrm import bce_loss, init_params
    from repro_torch.optim import rowwise_adagrad
    from repro_torch.quant.codecs import resolve_link_codecs

    cfg = DLRM_CONFIGS["wdl-tiny"]
    wl = WORKLOADS[cfg.workload]
    n, m, V = 4, 8, wl.vocab
    cap = int(0.2 * V)
    bw = DEFAULT_BANDWIDTHS(n)
    t_np = transmission_time_codec(cfg.embedding_dim, bw,
                                   resolve_link_codecs("uniform", bw, codec))
    cpu = init_params(cfg, wl, torch.Generator().manual_seed(seed), "cpu")
    runs = {}
    for key, dev, model in (("cpu", "cpu", cpu),
                            ("card", "cuda", copy.deepcopy(cpu).to("cuda"))):
        t = torch.tensor(t_np, dtype=torch.float32, device=dev)
        decide, advance, _, out_rows = make_dlrm_esd_stages(
            n, m, t, 1.0, exchange="ragged", capacity=cap, codec=codec)
        state = esd_sparse_init(n, V, cap, max_ids=out_rows * wl.width,
                                device=dev)
        train = make_train_step(model, bce_loss, rowwise_adagrad(1e-2),
                                codec)
        log = []
        for s, d, l in itertools.islice(wl.stream(seed + 1, n * m), 3):
            s = torch.as_tensor(s.astype(np.int32), device=dev)
            d, l = torch.as_tensor(d, device=dev), torch.as_tensor(l,
                                                                 device=dev)
            assign, _ = decide(state, s)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
            loss = train(s2, d2, l2)
            log.append(([assign, s2, l2, *counts.values()], d2, loss))
        runs[key] = log, [p.detach() for p in model.parameters()]
    (lc, pc), (lg, pg) = runs["cpu"], runs["card"]
    worst = dense_err = 0.0
    for (ints_c, d_c, loss_c), (ints_g, d_g, loss_g) in zip(lc, lg):
        for a, b in zip(ints_c, ints_g):
            check(torch.equal(a, b.cpu()), "training stages: assignment, "
                  "exchanged ids and labels and counts equal on card and "
                  "CPU")
        check(torch.allclose(d_c, d_g.cpu(), rtol=0, atol=1e-6),
              "exchanged dense features on card vs CPU within 1e-6")
        dense_err = max(dense_err, float((d_c - d_g.cpu()).abs().max()))
        check(torch.allclose(loss_c, loss_g.cpu(), rtol=1e-5, atol=1e-5),
              "training loss on card vs CPU within 1e-5")
        worst = max(worst, float((loss_c - loss_g.cpu()).abs()))
    for a, b in zip(pc, pg):
        check(torch.allclose(a, b.cpu(), rtol=1e-5, atol=1e-5),
              "trained parameters on card vs CPU within 1e-5")
        worst = max(worst, float((a - b.cpu()).abs().max()))
    print(f"[parity] 3 training steps, card vs CPU, wdl-tiny, codec "
          f"{codec or 'none'}: assignments, exchanged ids and labels and "
          f"counts equal; dense features max abs err {dense_err:.3g} "
          f"(tolerance 1e-6); losses {[round(float(x[2]), 6) for x in lg]}; "
          f"max abs err of losses and parameters {worst:.3g} (tolerance "
          f"1e-5)")


PIPE_PARITY = {"depth 2": ["--pipeline-depth", "2"],
               "stale": ["--pipeline-depth", "2", "--stale-decide"],
               "depth 3, decide-ahead 2, prefetch": [
                   "--pipeline-depth", "3", "--decide-ahead", "2",
                   "--lookahead", "2", "--prefetch", "16",
                   "--prefetch-slots", "64"]}


def phase_train_pipeline_parity(seed: int):
    """``run_dlrm`` pipelined at wdl-tiny (4 workers x 8, 5 steps), its
    chain on a stream of its own on the card, against the same run on the
    CPU from the same weights: every integer field equal, losses and
    Alg.-1 costs within 1e-5, the final prefetch plane's ids and expiry
    equal and its rows bit for bit."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.train import build_parser, run_dlrm
    from repro_torch.models.dlrm import init_params

    cfg = DLRM_CONFIGS["wdl-tiny"]
    cpu = init_params(cfg, WORKLOADS[cfg.workload],
                      torch.Generator().manual_seed(seed), "cpu")
    base = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker",
            "8", "--steps", "5", "--esd-alpha", "1", "--exchange", "ragged",
            "--seed", str(seed)]
    for what, extra in PIPE_PARITY.items():
        outs = {dev: run_dlrm(build_parser().parse_args(
                    base + extra + ["--device", dev]),
                    model=copy.deepcopy(cpu).to(dev))
                for dev in ("cpu", "cuda")}
        rc, rg = outs["cpu"]["metrics"], outs["cuda"]["metrics"]
        check(outs["cuda"]["stage_clock"] == "device",
              "the pipelined card run put its chain on a stream of its own")
        worst = 0.0
        for a, b in zip(rc, rg, strict=True):
            check(set(a) == set(b), f"{what}: the same record fields")
            for key, v in a.items():
                if key in ("loss", "alg1_est", "alg1_realized", "cost"):
                    check(math.isclose(b[key], v, rel_tol=1e-5, abs_tol=0),
                          f"{what}: {key} on card vs CPU within 1e-5")
                    worst = max(worst, abs(b[key] - v) / abs(v))
                elif key != "wall_s":
                    check(b[key] == v, f"{what}: {key} equal on card and CPU")
        pc, pg = outs["cpu"]["prefetch_plane"], outs["cuda"]["prefetch_plane"]
        if pc is not None:
            for key in ("ids", "expiry", "rows"):
                check(torch.equal(getattr(pc, key), getattr(pg, key).cpu()),
                      f"{what}: the final plane's {key} equal on card and "
                      f"CPU")
        print(f"[parity] run_dlrm {what}, card vs CPU, wdl-tiny, 5 steps: "
              f"integer fields equal, losses {[r['loss'] for r in rg]}, max "
              f"rel err of losses and costs {worst:.3g} (tolerance 1e-5)"
              + ("; the final plane's ids, expiry and rows equal"
                 if pc is not None else ""))


def phase_serve(seed: int, codec=None, duration: float = 1.0) -> dict:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.serve import build_parser, run_serve
    from repro_torch.serve import StreamConfig, request_arrivals

    argv = ["--arch", "wdl-s1", "--workers", "4", "--qps", "2000",
            "--duration", str(duration), "--max-batch", "16",
            "--ttl-batches", "32", "--refresh-budget", "64",
            "--device", "cuda", "--seed", str(seed)]
    if codec is not None:
        argv += ["--codec", codec]
    args = build_parser().parse_args(argv)
    _zero_launches()
    out = run_serve(args)
    launches = {k: v for k, v in _read_launches().items() if v}
    n_stream = len(request_arrivals(StreamConfig(
        workload=WORKLOADS["S1"], qps=2000.0, duration_s=duration,
        seed=seed))[0])
    per_batch = {k: round(v / out["n_batches"], 3)
                 for k, v in launches.items()}
    print(f"[serve] wdl-s1, codec {out['codec']}, {duration} s: n_requests "
          f"{out['n_requests']} in "
          f"{out['n_batches']} batches, p50 {out['p50_ms']:.3f} ms, "
          f"p99 {out['p99_ms']:.3f} ms, refresh_rows {out['refresh_rows']}, "
          f"slo_violation_rate {out['slo_violation_rate']:.4f}, decide "
          f"{out['decide_ms_mean']:.3f} ms/batch, worker step "
          f"{out['worker_step_ms_mean']:.3f} ms x {out['worker_steps']}; "
          f"launches {launches} ({per_batch} per micro-batch)")
    check(launches.get("pooled_lookup_staged", 0) > 0,
          "the pooled history bag kernel launched on the serving path")
    if codec is None:
        check(launches.get("staged_gather", 0) > 0,
              "the refresh kernel launched on the exact serving path")
    else:      # the quantized pull is a gather and the codec's round trip
        check("staged_gather" not in launches,
              "the quantized refresh pull skips the exact-pull kernel")
    check(out["n_requests"] == n_stream, "every request of the stream served")
    check(out["nonfinite_logits"] == 0, "all logits finite")
    check(out["refresh_rows"] > 0, "TTL refreshes happened")
    return launches


TRAIN_DEPTH1: dict = {}     # codec -> (run_dlrm summary, launches a step)


def phase_train(seed: int, codec=None) -> dict:
    from repro_torch.kernels import auction as A
    from repro_torch.launch.train import build_parser, run_dlrm

    argv = TRAIN_ARGV + ["--seed", str(seed)]
    if codec is not None:
        argv += ["--codec", codec]
    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    A.ROUNDS_LOG = []
    _zero_launches()
    try:
        out = run_dlrm(args)    # raises if a step's exchange overflowed
    finally:
        launches = {k: v for k, v in _read_launches().items() if v}
        solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    recs = out["metrics"]
    per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
    TRAIN_DEPTH1[codec] = out, per_step
    losses = [r["loss"] for r in recs]
    print(f"[train] wdl-s1, codec {out['codec']}, {out['workers']} workers x "
          f"{out['batch'] // out['workers']}, {len(recs)} steps: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; decide "
          f"{out['decide_ms_mean']:.3f} ms, advance "
          f"{out['advance_ms_mean']:.3f} ms, train "
          f"{out['train_ms_mean']:.3f} ms per step (mean of steps 1..), "
          f"{out['samples_per_s']:.1f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches} ({per_step} per step); exchange_overflow 0")
    for key in ("miss_pull", "update_push", "evict_push"):
        print(f"[train] {key} per step: {[r[key] for r in recs]}")
    print("[train] step ms (decide, advance, train) per step: " + str([
        tuple(round(x * 1e3, 2) for x in t) for t in zip(
            *(out["stage_s"][s] for s in ("decide", "advance", "train")))]))
    rounds = [r.sum(dim=1).tolist() for r in solves]
    print(f"[train] auction rounds per step, per worker: {rounds}")
    check(per_step.get("pooled_lookup") == 4.0,
          "pooled_lookup launched once per worker and step (decide)")
    check(per_step.get("auction_solve") == 1.0 and len(solves) == len(recs)
          and "auction_bids" not in launches,
          "the training auction ran as one auction_solve launch a step, "
          "never on the bid kernel")
    check(args.seed != 0 or rounds == TRAIN_ROUNDS[codec][:len(rounds)],
          "the training auction's rounds equal the CPU's "
          "(scripts/train_auction_rounds.py --device cpu)")
    pack, other = (("pack_send_all", "pack_send_all_quant") if codec is None
                   else ("pack_send_all_quant", "pack_send_all"))
    check(per_step.get(pack) == 1.0 and other not in launches
          and "gather_rows" not in launches,
          f"one {pack} launch a step packs the exchange, for every "
          f"worker and payload; gather_rows never runs on the step")
    check("gather_rows_quant" not in launches,
          "gather_rows_quant never runs on the step: the pack quantizes "
          "the dense features in its one launch")
    check(all(np.isfinite(losses)), "every training loss finite")
    check(all(r["miss_pull"] > 0 for r in recs), "miss_pull > 0 each step")
    return launches


# the README's pipelined configuration at full width
AHEAD_ARGV = ["--pipeline-depth", "4", "--lookahead", "4", "--decide-ahead",
              "3", "--prefetch", "64", "--prefetch-slots", "512"]


def phase_train_pipeline(seed: int) -> dict:
    """``run_dlrm`` at wdl-s1 pipelined: depth 2, exact and with
    ``--codec int8``, each record bit for bit phase 6's depth-1 record,
    the auction's rounds and the launches a step depth 1's; depth 2 with
    stale decisions; and the README's configuration (depth 4, lookahead 4,
    decide-ahead 3, 64 rows a step into 512 slots), its prefetch pull one
    staged_gather launch a step."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.kernels import auction as A
    from repro_torch.launch.train import build_parser, run_dlrm
    from repro_torch.quant.codecs import row_wire_bytes

    total: dict = {}

    def run(extra):
        args = build_parser().parse_args(TRAIN_ARGV + extra
                                         + ["--seed", str(seed)])
        A.ROUNDS_LOG = []
        _zero_launches()
        try:
            out = run_dlrm(args)
        finally:
            launches = {k: v for k, v in _read_launches().items() if v}
            solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        recs = out["metrics"]
        per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
        print(f"[train-pipeline] {' '.join(extra)}: wall "
              f"{out['wall_ms_mean']:.3f} ms a step (mean after the first "
              f"{out['pipeline_depth']}), device ms decide "
              f"{out['decide_ms_mean']:.3f}, advance "
              f"{out['advance_ms_mean']:.3f}, train "
              f"{out['train_ms_mean']:.3f}; host ms {out['host_ms_mean']}; "
              f"{out['samples_per_s']:.1f} samples/s; losses "
              f"{[r['loss'] for r in recs]}; launches {per_step} per step")
        check(out["stage_clock"] == "device",
              "the chain ran on a stream of its own")
        check(all(np.isfinite([r["loss"] for r in recs])),
              "every pipelined loss finite")
        return out, per_step, [r.sum(dim=1).tolist() for r in solves]

    keys = ("loss", "miss_pull", "update_push", "evict_push", "cost",
            "alg1_est")
    for codec in (None, "int8"):
        one, one_launch = TRAIN_DEPTH1[codec]
        extra = ["--pipeline-depth", "2"] + (["--codec", codec] if codec
                                             else [])
        out, per_step, rounds = run(extra)
        check([[r[k] for k in keys] for r in out["metrics"]]
              == [[r[k] for k in keys] for r in one["metrics"]],
              f"depth 2 (codec {codec}): every record bit for bit depth 1's")
        check(seed != 0 or rounds == TRAIN_ROUNDS[codec][:len(rounds)],
              f"depth 2 (codec {codec}): the auction's rounds equal the "
              f"CPU's")
        check(per_step == one_launch,
              f"depth 2 (codec {codec}): the launches a step equal depth "
              f"1's")
        print(f"[train-pipeline] codec {codec or 'none'}: wall ms a step, "
              f"depth 1 {one['wall_ms_mean']:.3f}, depth 2 "
              f"{out['wall_ms_mean']:.3f} (records, rounds and launches "
              f"equal)")

    out, _, _ = run(["--pipeline-depth", "2", "--stale-decide"])
    recs = out["metrics"]
    check(all("alg1_realized" in r for r in recs),
          "stale: every record has alg1_realized")
    check(math.isclose(recs[0]["alg1_realized"], recs[0]["alg1_est"],
                       rel_tol=1e-6),
          "stale: step 0 decides on the committed state (realized = est)")

    out, per_step, _ = run(AHEAD_ARGV)
    recs = out["metrics"]
    wire = row_wire_bytes(DLRM_CONFIGS[TRAIN_ARGV[1]].embedding_dim, None)
    check(per_step.get("staged_gather") == 1.0,
          "the prefetch pull launched staged_gather once a step")
    check(all(r["prefetch_bytes"] > 0 for r in recs[1:]),
          "prefetch_bytes > 0 after step 0")
    check(all(r["demand_miss_bytes"] <= r["miss_pull"] * wire for r in recs),
          "demand misses never exceed misses")
    check(all("n_reassigned" in r and "alg1_realized" in r for r in recs),
          "n_reassigned and alg1_realized in every record")
    print(f"[train-pipeline] README configuration: prefetch_bytes "
          f"{[r['prefetch_bytes'] for r in recs]}, prefetch_hit_rate "
          f"{[r['prefetch_hit_rate'] for r in recs]}, n_reassigned "
          f"{[r['n_reassigned'] for r in recs]}, window_dedup_frac "
          f"{[r['window_dedup_frac'] for r in recs]}")
    return total


def phase_auction_kernels(seed: int) -> dict:
    """B7, the auction's bids, at Table 2's and the simulator's shapes."""
    from repro_torch.kernels import auction as A

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 13)
    rec = {}
    for k, n in ((256, 8), (8192, 8), (1024, 16), (64, 1)):
        cost = torch.as_tensor(rng.random((k, n), dtype=np.float32),
                               device=dev)
        # prices on a coarse grid, so that values tie inside rows
        price = torch.as_tensor(
            np.round(rng.random(n) * 4).astype(np.float32) / 8, device=dev)
        unassigned = torch.as_tensor(rng.random(k) < 0.5, device=dev)
        eps = torch.tensor([1.0 / (k + 1)], dtype=torch.float32, device=dev)
        best_j, bid = A.auction_bids(cost, price, unassigned, eps)
        ref_j, ref_bid = A.auction_bids_ref(cost, price, unassigned, eps[0])
        torch.cuda.synchronize()
        check(torch.equal(best_j, ref_j.to(torch.int32))
              and torch.equal(bid.view(torch.int32), ref_bid.view(torch.int32)),
              f"auction_bids k={k} n={n}: best_j and bid bitwise equal to "
              f"plain")
        err = float((bid - ref_bid).abs().max())
        ms, call_ms = device_ms(
            lambda: A.auction_bids(cost, price, unassigned, eps))
        plain_ms, _ = device_ms(
            lambda: A.auction_bids_ref(cost, price, unassigned, eps[0]))
        # cost and prices read, mask read, best_j and bid written; a
        # negate, a subtract and two compares per value
        b_ms, b_by = bound(k * n * 4 + n * 4 + k + 2 * k * 4, 4 * k * n)
        print(f"[kernel] auction_bids k={k} n={n} "
              f"unassigned={int(unassigned.sum())}: bitwise, {ms:.4f} ms "
              f"(call {call_ms:.4f}), plain {plain_ms:.4f} ms, library none,"
              f" bound {b_ms:.6f} ms ({b_by})")
        if (k, n) == (256, 8):
            rec["auction_bids"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by)
    rec["auction_solve"] = phase_solve_kernel(seed)
    return rec


def phase_solve_kernel(seed: int) -> dict:
    """B7's fused whole-solve kernel against its plain version on the
    card, bit for bit in assignment, slot prices, slot owners and rounds,
    at the training step's decide (4 auctions of 256 x 4, capacity 64,
    ``auction_fixed``'s nine phases), the S1 simulator's decisions (256 x
    8, capacity 32, exact grid, ``_solve``'s phases; and a price war of
    tied columns, its phases cut at 3,000 rounds) and Table 2's largest
    (8,192 x 8, capacity 1,024).  Its time a solve and a round (over the
    longest of the batch's auctions), and a bound from the bytes the
    rounds' bid passes read (each bidder's cost row, in every round it
    bids) plus the eps table and the outputs."""
    from repro_torch.core.auction import phase_eps
    from repro_torch.core.dispatch import _eps
    from repro_torch.kernels import auction as A

    def span(C):
        return float(np.float32(C.max()) - np.float32(C.min()))

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 19)
    grid = np.round(rng.random((4, 256, 4)) * 4e3).astype(np.float32)
    decide = grid / np.float32(4e3) * np.float32(1e-3)
    s1 = np.round(rng.random((1, 256, 8)) * 10_000).astype(np.float32)
    war = np.round(rng.random((1, 256, 8)) * 10_000).astype(np.float32)
    war[:, :, 4:] = war[:, :, :4]                 # tied columns
    t2 = rng.random((1, 8192, 8)).astype(np.float32)
    spans = (decide.max(axis=(1, 2)) - decide.min(axis=(1, 2))).clip(1e-6)
    fixed_eps = torch.stack([_eps(torch.as_tensor(spans), min(p, 6))
                             for p in range(9)], dim=1)
    cases = (("decide", decide, 64, fixed_eps, 2000),
             ("s1", s1, 32, [phase_eps(span(s1), 1 / 257)], 200_000),
             ("s1-war", war, 32, [[1 / 257] * 2], 3000),
             ("table2", t2, 1024, [phase_eps(span(t2), span(t2) * 1e-3)],
              200_000))
    out = {}
    for what, C, cap, eps, max_rounds in cases:
        cost = torch.as_tensor(C, device=dev)
        eps = torch.as_tensor(np.asarray(eps, np.float32), device=dev)
        got = A.auction_solve(cost, cap, eps, max_rounds)
        # the plain version on the same card tensors, counting each
        # round's bidders
        bidders = [0]
        body = A._round_body

        def counted(c, e, state):
            bidders[0] += int((state[0] < 0).sum())
            return body(c, e, state)

        A._round_body = counted
        try:
            t = time.perf_counter()
            want = A.auction_solve_ref(cost, cap, eps, max_rounds)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
        finally:
            A._round_body = body
        same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, want)]
        check(all(same), f"auction_solve {what}: assignment, slot prices, "
                         f"slot owners and rounds bitwise equal to plain "
                         f"({same})")
        B, k, n = C.shape
        rounds = got[3].sum(dim=1)
        longest = int(rounds.max())
        ms, call_ms = device_ms(
            lambda: A.auction_solve(cost, cap, eps, max_rounds),
            reps=10 if what in ("s1-war", "table2") else 30)
        n_bytes = (bidders[0] * n * 4 + eps.numel() * 4
                   + B * (k * 4 + 2 * n * cap * 4) + got[3].numel() * 4)
        b_ms, b_by = bound(n_bytes, 4 * bidders[0] * n)
        smem = A.solve_smem_bytes(k, n, cap, True)
        print(f"[kernel] auction_solve {what} B={B} k={k} n={n} c={cap} "
              f"(cost in {'shared memory' if smem <= A.SMEM_MAX else 'L2'}):"
              f" bitwise, rounds {rounds.tolist()} ({bidders[0]} bids), "
              f"{ms:.4f} ms a solve (call {call_ms:.4f}), "
              f"{ms / max(longest, 1) * 1e3:.3f} us a round; plain "
              f"{plain_ms:.1f} ms (one run, host clock), library none, bound"
              f" {b_ms:.6f} ms ({b_by})")
        if what == "decide":
            out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
    return out


def phase_sim_parity(seed: int):
    """The simulator with the auction, and the serving simulator, on the
    card against the CPU: every field but wall-clock time equal."""
    from repro_torch.core.simulator import GBPS, SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import auction as A
    from repro_torch.serve import ServeKnobs, simulate_serve

    # 4 workers on distinct link speeds: a cold cache on two speed classes
    # starts a price war of about a million rounds, too long for the CPU
    base = dict(workload=WORKLOADS["tiny"], n_workers=4, batch_per_worker=8,
                iters=4, warmup=1, alpha=1.0, opt="auction", seed=seed,
                bandwidths=np.array([5.0, 2.0, 1.0, 0.5]) * GBPS)
    runs = {}
    for dev in ("cuda", "cpu"):
        A.ROUNDS_LOG = []
        n0 = A.LAUNCHES["auction_solve"]
        try:
            res = simulate(SimConfig(device=dev, **base))
        finally:
            log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        runs[dev] = (res, [int(r.sum()) for r in log],
                     A.LAUNCHES["auction_solve"] - n0)
    (card, card_rounds, launched), (cpu, cpu_rounds, _) = (runs["cuda"],
                                                           runs["cpu"])
    for f in ("per_iter_cost", "alg1_cost", "ingredient", "hit_ratio",
              "cost"):
        a, b = getattr(card, f), getattr(cpu, f)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        check(same, f"simulate(opt='auction') {f} equal on card and CPU")
    check(card_rounds == cpu_rounds and launched == len(card_rounds) > 0,
          "the card's simulate solved each decision in one auction_solve "
          "launch, in the CPU's rounds")
    print(f"[parity] simulate tiny, 4 workers x 8, opt auction, 4 "
          f"iterations, card vs CPU: per_iter_cost, alg1_cost, ingredient, "
          f"hit_ratio equal; cost {card.cost!r}; rounds a decision "
          f"{card_rounds} on both; {launched} auction_solve launches")
    knobs = ServeKnobs(qps=2000.0, duration_s=0.5)
    scfg = dict(workload=WORKLOADS["S1"], n_workers=8, opt="auction",
                seed=seed, serve=knobs)
    card = simulate_serve(SimConfig(device="cuda", **scfg))
    cpu = simulate_serve(SimConfig(device="cpu", **scfg))
    for f in ("p50_s", "p99_s", "mean_s", "slo_violation_rate", "n_requests",
              "n_batches", "pull_rows", "refresh_rows", "staleness_p99_s"):
        check(getattr(card, f) == getattr(cpu, f),
              f"simulate_serve {f} equal on card and CPU")
    check(np.array_equal(card.qps_per_worker, cpu.qps_per_worker),
          "simulate_serve qps_per_worker equal on card and CPU")
    print(f"[parity] simulate_serve S1, 8 workers, 2,000 QPS for 0.5 s, opt "
          f"auction, card vs CPU: all fields equal; p99 "
          f"{card.p99_s * 1e3:.4f} ms, {card.n_batches} batches")


# simulate() at S1 with ESD and the auction (phase 8's configuration,
# calibrated decisions, seed 0) on the CPU: scripts/auction_rounds.py
# --device cpu
S1_AUCTION_CPU = dict(rounds=1_045_650, cost=0.8131805183999999,
                      itps=23.408870950827136, hit_ratio=0.268820068282525)

# the paper's Table 2: CUDA-parallel Hungarian ms by samples per worker
PAPER_TABLE2_MS = {32: 21, 64: 28, 128: 82, 256: 186, 512: 811, 1024: 1385}


def phase_table2() -> dict:
    """Table 2's solver sweep: ``auction_dispatch(exact=False)`` on the
    draws of ``benchmarks/table2.py`` (``default_rng(0)``, 8 workers)."""
    from repro_torch.core.auction import auction_dispatch

    rng = np.random.default_rng(0)
    costs = {bpw: rng.random((8 * bpw, 8)) for bpw in PAPER_TABLE2_MS}
    # the CPU's answers first, outside the counted run
    refs = {bpw: auction_dispatch(c, bpw, exact=False, device="cpu",
                                  return_rounds=True)
            for bpw, c in costs.items()}
    _zero_launches()
    solves = 0
    for bpw, cost in costs.items():
        before = _read_launches()["auction_solve"]
        assign, rounds = auction_dispatch(cost, bpw, exact=False,
                                          device="cuda", return_rounds=True)
        launched = _read_launches()["auction_solve"] - before
        check(launched == 1, f"table 2 bpw {bpw}: one auction_solve launch "
                             f"a decision ({launched})")
        ref, ref_rounds = refs[bpw]
        check(np.array_equal(assign, ref) and rounds == ref_rounds,
              f"table 2 bpw {bpw}: assignment and rounds equal on card and "
              f"CPU")
        check(bool((np.bincount(assign, minlength=8) == bpw).all()),
              f"table 2 bpw {bpw}: every worker takes its {bpw} samples")
        times = []
        for _ in range(3):
            t = time.perf_counter()
            auction_dispatch(cost, bpw, exact=False, device="cuda")
            times.append((time.perf_counter() - t) * 1e3)
        solves += 4
        print(f"[table2] bpw {bpw} (k = {8 * bpw}, n = 8): {rounds} rounds, "
              f"{statistics.median(times):.3f} ms per decision (median of "
              f"3 after a warm call, host clock; "
              f"{statistics.median(times) / rounds * 1e3:.3f} us a round), "
              f"{launched} auction_solve launch; paper's CUDA Hungarian "
              f"{PAPER_TABLE2_MS[bpw]} ms")
    launches = {k: v for k, v in _read_launches().items() if v}
    check(launches == {"auction_solve": solves},
          "table 2: one auction_solve launch a decision, nothing else")
    return launches


def phase_simulate(seed: int) -> dict:
    """The paper's simulator at S1 on the card, each mechanism in turn.
    ESD with the auction runs the calibrated decision model, so that its
    cost, ItpS and hit ratio do not hold the host's wall time and equal
    the CPU's (``S1_AUCTION_CPU``) at seed 0; the others measure their
    decisions."""
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import auction as A
    from repro_torch.serve import ServeKnobs, simulate_serve

    base = dict(workload=WORKLOADS["S1"], n_workers=8, batch_per_worker=32,
                cache_ratio=0.08, embedding_dim=512, iters=8, warmup=2,
                seed=seed, decision_model="measured", device="cuda")
    launches: dict = {}
    costs = {}
    for name, kw in (("esd-auction", dict(mechanism="esd", opt="auction",
                                          decision_model="calibrated")),
                     ("esd-ssp", dict(mechanism="esd", opt="ssp")),
                     ("laia", dict(mechanism="laia")),
                     ("het", dict(mechanism="het")),
                     ("fae", dict(mechanism="fae")),
                     ("random", dict(mechanism="random"))):
        A.ROUNDS_LOG = []
        _zero_launches()
        t = time.perf_counter()
        try:
            res = simulate(SimConfig(**{**base, **kw}))
        finally:
            wall = time.perf_counter() - t
            run = {k: v for k, v in _read_launches().items() if v}
            log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        rounds = [int(r.sum()) for r in log]
        solves = run.get("auction_solve", 0)
        check(bool(np.isfinite(res.per_iter_cost).all())
              and len(res.per_iter_cost) == 6 and 0 <= res.hit_ratio <= 1,
              f"simulate {name}: six finite iteration costs, hit ratio in "
              f"[0, 1]")
        check(solves == len(rounds) and (solves > 0) == (name == "esd-auction")
              and "auction_bids" not in run,
              f"simulate {name}: the auction runs only for ESD with the "
              f"auction, one auction_solve launch a decision")
        if name == "esd-auction" and seed == 0:
            got = dict(rounds=sum(rounds), cost=res.cost, itps=res.itps,
                       hit_ratio=res.hit_ratio)
            check(got == S1_AUCTION_CPU, f"simulate esd-auction: rounds, "
                  f"cost, ItpS and hit ratio equal the CPU's ({got} against"
                  f" {S1_AUCTION_CPU})")
        costs[name] = res.cost
        extra = (f", auction_solve launches {solves}, rounds {sum(rounds)} "
                 f"{rounds} ({wall / max(sum(rounds), 1) * 1e6:.3f} us a "
                 f"round of the wall)" if solves else "")
        print(f"[simulate] S1 {name}: cost {res.cost!r} s, itps "
              f"{res.itps!r}, hit ratio {res.hit_ratio!r}, decision "
              f"{res.decision_time_mean * 1e3:.3f} ms (mean of iterations "
              f"2-7{', calibrated' if solves else ''}){extra}, wall "
              f"{wall:.1f} s")
    check(costs["esd-auction"] < costs["random"],
          "ESD with the auction moves less than random dispatch")
    A.ROUNDS_LOG = []
    _zero_launches()
    try:
        res = simulate_serve(SimConfig(
            workload=WORKLOADS["S1"], n_workers=8, opt="auction", seed=seed,
            device="cuda", serve=ServeKnobs(qps=2000.0, duration_s=0.5)))
    finally:
        run = {k: v for k, v in _read_launches().items() if v}
        log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v
    solves = run.get("auction_solve", 0)
    check(solves == len(log) > 0 and res.n_requests > 0
          and np.isfinite(res.p99_s),
          "simulate_serve with the auction served the stream, one "
          "auction_solve launch a decision")
    print(f"[simulate] serve S1, 8 workers, 2,000 QPS for 0.5 s, opt "
          f"auction: p50 {res.p50_s * 1e3:.4f} ms, p99 "
          f"{res.p99_s * 1e3:.4f} ms, slo_violation_rate "
          f"{res.slo_violation_rate:.4f}, {res.n_requests} requests in "
          f"{res.n_batches} batches, auction_solve launches {solves}, "
          f"rounds {sum(int(r.sum()) for r in log)}")
    return launches


def phase_flash_kernels(seed: int) -> dict:
    """B8, the flash attention, and its backward kernel, at the LM path's
    shape and around it."""
    from repro_torch.kernels import flash_attn as FA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    rec = {}

    def qkv(B, S, KV, G, hd, dtype):
        return (torch.randn((B, S, KV, G, hd), generator=g,
                            device=dev).to(dtype),
                torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype),
                torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype))

    def sdpa(q, k, v, causal):
        """The library yardstick on the (B, H, S, hd) layout it takes,
        back in B8's layout."""
        B, S, KV, G, hd = q.shape
        out = torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, S, KV * G, hd).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=causal, enable_gqa=True)
        return out.transpose(1, 2).reshape(B, S, KV, G, hd)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def pairs(B, S, KV, G, causal):
        return B * KV * G * (S * (S + 1) // 2 if causal else S * S)

    for B, S, KV, G, hd, causal, dtype in (
            (4, 2048, 5, 3, 64, True, torch.bfloat16),
            (4, 2048, 5, 3, 64, True, torch.float32),
            (2, 1024, 5, 3, 64, False, torch.bfloat16),
            (2, 2048, 2, 4, 128, True, torch.bfloat16),
            (2, 2048, 4, 2, 32, True, torch.bfloat16)):
        q, k, v = qkv(B, S, KV, G, hd, dtype)
        out, lse = FA.flash_attention(q, k, v, causal)
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        e, lse_err = err(out, ref), err(lse, ref_lse)
        what = (f"B={B} S={S} KV={KV} G={G} hd={hd} "
                f"{'causal' if causal else 'full'} "
                f"{'bf16' if bf16 else 'f32'}")
        if bf16:
            # P rounded to bf16 for the tensor cores, as SDPA does: 1e-2,
            # or up to 2e-2 within 1.5x SDPA's error on the same inputs
            sdpa_err = err(sdpa(q, k, v, causal), ref)
            ok = e <= 1e-2 or (e <= 2e-2 and e <= 1.5 * sdpa_err)
            tol = (f"1e-2, or 2e-2 and 1.5x SDPA's {sdpa_err:.3g}")
        else:
            ok, tol = e <= 2e-5, "2e-5"
        check(ok and lse_err <= 2e-5 and out.dtype == dtype,
              f"flash_attention {what}: out within {tol} (max err {e}), "
              f"lse within 2e-5 (max err {lse_err}) of plain")
        ms, call_ms = device_ms(lambda: FA.flash_attention(q, k, v, causal))
        plain_ms, _ = device_ms(
            lambda: FA.flash_attention_ref(q, k, v, causal), reps=10)
        qs = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms, _ = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True))
        # 4 hd operations per visible (query row, key) pair; q, k, v read
        # once, out and lse written once
        n_ops = 4 * hd * pairs(B, S, KV, G, causal)
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by = bound(n_bytes, n_ops,
                           BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
        route = FA.kernel_route((dtype,) * 3, hd)
        print(f"[kernel] flash_attention {what} ({route}): max err {e:.3g} "
              f"(lse {lse_err:.3g}; tolerance {tol}), {ms:.4f} ms (call "
              f"{call_ms:.4f}), {n_ops / ms / 1e9:.2f} TFLOP/s, "
              f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if (S, hd, causal, dtype) == (2048, 64, True, torch.bfloat16):
            rec["flash_attention"] = dict(
                max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)
        del q, k, v, qs, ks, vs, out, ref

    # the backward kernel against the plain backward, and SDPA's backward
    for B, S, KV, G, hd, causal, dtype in (
            (4, 2048, 5, 3, 64, True, torch.bfloat16),
            (4, 2048, 5, 3, 64, True, torch.float32),
            (2, 1024, 5, 3, 64, False, torch.bfloat16),
            (2, 2048, 2, 4, 128, True, torch.bfloat16)):
        q, k, v = qkv(B, S, KV, G, hd, dtype)
        out, lse = FA.flash_attention(q, k, v, causal)
        dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        got = FA.flash_attention_backward(q, k, v, out, lse, dout, causal)
        # the plain backward in f32 on the same values (for bf16, so that
        # neither error below is a count of output ulps)
        want = FA.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(), causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs = [err(a, b) for a, b in zip(got, want)]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        so = sdpa(*leaves, causal)
        sg = torch.autograd.grad(so, leaves, dout, retain_graph=True)
        sdpa_errs = [err(a, b) for a, b in zip(sg, want)]
        mean_ratio = [float((a.float() - w).abs().mean()
                            / (b.float() - w).abs().mean())
                      for a, b, w in zip(got, sg, want)]
        what = (f"B={B} S={S} KV={KV} G={G} hd={hd} "
                f"{'causal' if causal else 'full'} "
                f"{'bf16' if bf16 else 'f32'}")
        for name, e, se, a in zip(("dq", "dk", "dv"), errs, sdpa_errs, got):
            # bf16: P and dS rounded to bf16 for the tensor cores, as in
            # SDPA's backward
            check(a.dtype == dtype and (e <= 1.5 * se if bf16 else e <= 1e-4),
                  f"flash_attention_bwd {what}: {name} max err {e} within "
                  f"{'1.5x SDPA backward' + repr(se) if bf16 else '1e-4'}")
        ms, call_ms = device_ms(lambda: FA.flash_attention_backward(
            q, k, v, out, lse, dout, causal))
        plain_ms, _ = device_ms(lambda: FA.flash_attention_bwd(
            q, k, v, out, lse, dout, causal), reps=5)
        # SDPA's backward alone, on the (B, H, S, hd) layout it takes
        hs = [t.detach().contiguous().requires_grad_() for t in (
            q.reshape(B, S, KV * G, hd).transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2))]
        hout = torch.nn.functional.scaled_dot_product_attention(
            *hs, is_causal=causal, enable_gqa=True)
        hdout = dout.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        lib_ms, _ = device_ms(lambda: torch.autograd.grad(
            hout, hs, hdout, retain_graph=True), reps=20)
        # 10 hd operations per visible pair (five products); q, k, v, out,
        # dout and lse read once, dq, dk, dv written once
        n_ops = 10 * hd * pairs(B, S, KV, G, causal)
        n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by = bound(n_bytes, n_ops,
                           BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
        print(f"[kernel] flash_attention_bwd {what} "
              f"({'mma.sync' if bf16 else 'CUDA cores'}): max err dq, dk, dv "
              f"{[float(f'{x:.3g}') for x in errs]} (SDPA's backward "
              f"{[float(f'{x:.3g}') for x in sdpa_errs]}; mean error "
              f"over SDPA's {[round(x, 3) for x in mean_ratio]}), {ms:.4f} ms "
              f"(call {call_ms:.4f}), {n_ops / ms / 1e9:.2f} TFLOP/s, plain "
              f"{plain_ms:.4f} ms, SDPA's backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        if (S, hd, causal, dtype) == (2048, 64, True, torch.bfloat16):
            rec["flash_attention_bwd"] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, dout, got, want, leaves, so, sg, hs, hout

    # gradients through the autograd Function (f32: the forward's and the
    # backward's CUDA-core kernels) against autograd of the plain version
    worst = 0.0
    for causal in (True, False):
        leaves = [t.float() for t in qkv(2, 640, 5, 3, 64, torch.float32)]
        w = torch.randn(leaves[0].shape, generator=g, device=dev)
        grads = []
        for fn in (lambda *a: FA.flash_attn(*a, causal),
                   lambda *a: FA.flash_attention_ref(*a, causal)[0]):
            ts = [t.clone().requires_grad_() for t in leaves]
            grads.append(torch.autograd.grad((fn(*ts) * w).sum(), ts))
        for a, b in zip(*grads):
            e = float((a - b).abs().max())
            check(e <= 1e-4, f"flash_attn gradient (causal {causal}) "
                             f"within 1e-4 of plain (max err {e})")
            worst = max(worst, e)
    print(f"[kernel] flash_attn gradients, B=2 S=640 KV=5 G=3 hd=64 f32, "
          f"causal and full: max abs err {worst:.3g} against autograd of "
          f"the plain version (tolerance 1e-4)")
    return rec


def phase_lm_parity(seed: int):
    """3 steps of ``run_lm`` at smollm-360m's smoke config with S = 2,048
    (every layer on the flash route) on the card and on the CPU from the
    same weights: in f32, losses within 1e-4 (f32 sums in another order,
    and Adam at lr 1e-2 turns a rounding difference of a gradient near 0
    into a step of up to lr); in bf16 (the card's wgmma forward and
    tensor-core backward against the CPU's plain versions, which keep P
    and dS in f32), losses within 5e-2 (bf16 keeps 8 bits: activations
    and P rounded at other places move the loss of about 7 by up to a few
    of its 2**-5 ulps at this magnitude, and Adam turns gradient
    differences near 0 into steps of up to lr)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models import api

    argv = ["--arch", "smollm-360m", "--smoke", "--seq-len", "2048",
            "--batch-per-worker", "1", "--steps", "3", "--seed", str(seed)]
    base = get_config("smollm-360m", smoke=True)
    for cfg, tol in ((base, 1e-4),
                     (dataclasses.replace(base, dtype="bfloat16"), 5e-2)):
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            n0 = dict(FA.LAUNCHES)
            out = run_lm(build_parser().parse_args(argv + ["--device", dev]),
                         model=model, cfg=cfg)
            runs[dev] = [r["loss"] for r in out["metrics"]]
            ran = {k: FA.LAUNCHES[k] - n0[k] for k in n0}
        err = max(abs(a - b) for a, b in zip(runs["cpu"], runs["cuda"]))
        check(all(np.isfinite(runs["cuda"])) and err <= tol,
              f"LM losses ({cfg.dtype}) on card vs CPU within {tol} (max "
              f"err {err})")
        check(ran == {k: cfg.n_layers * 3 for k in ran},
              f"the card's {cfg.dtype} LM steps ran B8's forward and "
              f"backward kernels once per layer and step ({ran})")
        print(f"[parity] 3 LM steps, smollm-360m smoke (2 layers, d 256, 4 "
              f"heads over 2, {cfg.dtype}), B 1, S 2048, card vs CPU: "
              f"losses {runs['cuda']} vs {runs['cpu']}, max abs err "
              f"{err:.3g} (tolerance {tol}); card kernel launches {ran}")


def phase_lm_train(seed: int) -> dict:
    """``run_lm`` at smollm-360m's full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_parser, run_lm

    args = build_parser().parse_args(LM_ARGV + ["--seed", str(seed)])
    cfg = get_config(args.arch)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = run_lm(args)
    launches = {k: v for k, v in _read_launches().items() if v}
    recs = out["metrics"]
    losses = [r["loss"] for r in recs]
    print(f"[lm-train] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), B {out['batch']}, S {out['seq_len']}, "
          f"{len(recs)} steps: {out['step_ms_mean']:.3f} ms per step (mean "
          f"of steps 1..), {out['tokens_per_s']:.1f} tokens/s; losses "
          f"{losses}; step s {[r['wall_s'] for r in recs]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    check(all(np.isfinite(losses)), "every LM loss finite")
    check(launches.get("flash_attention") == cfg.n_layers * len(recs),
          "the flash kernel launched once per layer and step")
    check(launches.get("flash_attention_bwd") == cfg.n_layers * len(recs),
          "the flash backward kernel launched once per layer and step")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    rec = phase_kernels(args.seed)
    rec.update(phase_train_kernels(args.seed))
    rec.update(phase_quant_kernels(args.seed))
    rec.update(phase_auction_kernels(args.seed))
    rec.update(phase_flash_kernels(args.seed))
    phase_parity(args.seed)
    phase_train_parity(args.seed)
    phase_train_parity(args.seed, codec="int8")
    phase_sim_parity(args.seed)
    phase_lm_parity(args.seed)
    phase_train_pipeline_parity(args.seed)
    # launches on the main paths: each run counted from zero, then summed
    launches: dict = {}
    for run in (lambda: phase_serve(args.seed),
                lambda: phase_serve(args.seed, codec="int8", duration=0.5),
                lambda: phase_train(args.seed),
                lambda: phase_train(args.seed, codec="int8"),
                phase_table2,
                lambda: phase_simulate(args.seed),
                lambda: phase_lm_train(args.seed),
                lambda: phase_train_pipeline(args.seed)):
        t = time.perf_counter()
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
        print(f"[wall] phase took {time.perf_counter() - t:.1f} s")
    # B5, the row pack and the pack-quantize alone and the standalone bid
    # kernel run on no driver path (phase 3 holds them); every other
    # kernel must have launched on a main path
    for k in SOURCES:
        check(k in ("pooled_lookup_quant", "auction_bids", "gather_rows",
                    "gather_rows_quant")
              or launches.get(k, 0) > 0, f"{k} launched on a main path")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches.get(k, 0),
                    **{"library_ms": None, **rec[k]})
               for k in SOURCES]
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
