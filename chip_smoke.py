"""Drive the PyTorch port's serving path and training step, exact and
over the quantized wire, and the paper's simulator with its auction
solver, on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and ``nvidia-smi``'s name and power limit;
2. build — compiles the CUDA sources in ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all at once, and prints each kernel's
   registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its median time, the plain version's, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over 67 TFLOP/s f32).  Serving (wdl-s1: V = 502,000, E = 512): the
   hot-set plane of C rows, bags of the stream's 48 history slots.
   Training: the decide stage's per-id cost table (U, 4) pooled over one
   S1 batch of 256 x 74 (and the pooled lookup again at E = 512 on the
   wdl-s1 table), and the exchange's packs of 256 slots of ids (74
   int32), dense features (13 f32) and labels (1 f32).  The quantized
   wire: the fused pack-quantize of 256 slots of dense features (fp16,
   int8, int4, int8:4; and int8 at 512 columns), and the pooled lookup
   over the int8-quantized wdl-s1 table (256 x 74, E = 512 and E = 4).
   The auction's bids at Table 2's and the simulator's shapes (k = 256
   and 8,192 rows of 8 workers, 1,024 of 16, 64 of 1; a random
   unassigned mask), bit for bit;
4. parity — the serve step and a TTL refresh, and 3 steps of the training
   stages, exact and with ``--codec int8``, on the card against the same
   calls on the CPU at wdl-tiny; the simulator with ``opt="auction"``
   (tiny workload, 4 workers on distinct links, 4 iterations) and the
   serving simulator (S1, 8 workers, 0.5 s) on the card against the CPU;
5. serve — ``run_serve`` at wdl-s1 (4 workers, 2,000 QPS for 1 s), then
   for 0.5 s with ``--codec int8``;
6. train — ``run_dlrm`` at wdl-s1 (4 workers x 256 samples, ESD alpha 1,
   ragged exchange, 10 steps), then again with ``--codec int8``;
7. table 2 — ``auction_dispatch(exact=False)`` on the draws of
   ``benchmarks/table2.py`` (8 workers, 32 to 1,024 samples a worker):
   rounds, ms per decision and bid-kernel launches, beside the paper's
   CUDA-Hungarian ms; assignments and rounds equal to the CPU's;
8. simulate — ``simulate`` at S1 (8 workers, 4 x 5 and 4 x 0.5 Gbps,
   r = 0.08, E = 512, 32 samples a worker, 8 iterations, 2 of warm-up;
   the paper's 60 iterations and 128 a worker cut): ESD alpha 1 with the
   auction and with SSP, LAIA, HET, FAE and random; then the serving
   simulator with the auction.

Each run of phases 5 to 8 sets every kernel's launch counter to 0 just
before and reads the counters just after.  Then one JSON line of kernel
records, after the script's wall time, and as the last line ``{"ok":
true, "device": {...}}``.  Any failed check raises, so the script exits
non-zero; it also fails without a CUDA device and when the package is
not beside it.
"""
from __future__ import annotations

import argparse
import copy
import itertools
import json
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
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"pooled_lookup": CSRC + "emb_lookup.cu",
           "gather_rows": CSRC + "exchange_pack.cu",
           "staged_gather": CSRC + "emb_lookup.cu",
           "pooled_lookup_staged": CSRC + "emb_lookup.cu",
           "gather_rows_quant": CSRC + "exchange_pack.cu",
           "pooled_lookup_quant": CSRC + "emb_lookup.cu",
           "auction_bids": CSRC + "auction.cu"}
REPLACES = {"pooled_lookup": "src/repro/kernels/emb_lookup.py:88",
            "gather_rows": "src/repro/kernels/exchange_pack.py:34",
            "staged_gather": "src/repro/kernels/emb_lookup.py:174",
            "pooled_lookup_staged": "src/repro/kernels/emb_lookup.py:245",
            "gather_rows_quant": "src/repro/kernels/exchange_pack.py:108",
            "pooled_lookup_quant": "src/repro/kernels/emb_lookup.py:337",
            "auction_bids": "src/repro/kernels/auction.py:51"}
TRAIN_ARGV = ["--arch", "wdl-s1", "--workers", "4", "--batch-per-worker",
              "256", "--steps", "10", "--esd-alpha", "1", "--exchange",
              "ragged", "--capacity-ratio", "0.2", "--device", "cuda"]


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


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / F32_FLOPS_PER_S * 1e3
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

    names = ("emb_lookup", "exchange_pack", "auction")
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
                kernel = next((k for k in SOURCES if f"{k}_kernel" in ln),
                              ln.split("'")[1] if "'" in ln else ln)
            elif "spill" in ln or "registers" in ln:
                facts.append(ln.split(":", 1)[-1].strip())
                if "registers" in ln:
                    print(f"[build] {name} {kernel}: " + "; ".join(facts))
                    facts = []


def _launch_counters():
    from repro_torch.kernels import auction, emb_lookup, exchange_pack

    return (emb_lookup.LAUNCHES, exchange_pack.LAUNCHES, auction.LAUNCHES)


def _zero_launches():
    for counts in _launch_counters():
        for k in counts:
            counts[k] = 0


def _read_launches() -> dict:
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def phase_train_kernels(seed: int) -> dict:
    """B1 and B2 at the training step's shapes."""
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
    return rec


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

    # pooled_lookup_staged: history bags of the synthetic stream against
    # the hot-set plane, at the serving micro-batch and at a large batch
    plane = PrefetchPlane(ids=torch.as_tensor(hot.astype(np.int32),
                                              device=dev),
                          rows=plane_rows,
                          expiry=torch.full((C,), 1, dtype=torch.int32,
                                            device=dev))
    smap = slot_map(plane, V, 0)
    for B in (16, 4096):
        hist = wl.sample_batch(rng, B)[:, F:]
        ids = torch.as_tensor(hist.astype(np.int32), device=dev)
        slots = torch.where(ids >= 0, smap[ids.long().clamp(min=0)], -1)
        out = K.pooled_lookup_staged(plane_rows, table, slots, ids)
        ref = K.pooled_lookup_staged_ref(plane_rows, table, slots, ids)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
              f"pooled_lookup_staged B={B} within 1e-5 (max err {err})")
        ms, call_ms = device_ms(
            lambda: K.pooled_lookup_staged(plane_rows, table, slots, ids))
        plain_ms, plain_call = device_ms(
            lambda: K.pooled_lookup_staged_ref(plane_rows, table, slots,
                                               ids), reps=20)
        valid = hist >= 0
        s_np = slots.cpu().numpy()
        n_rows = (len(np.unique(s_np[valid & (s_np >= 0)]))
                  + len(np.unique(hist[valid & (s_np < 0)])))
        n_bytes = (n_rows + B) * E * 4 + 2 * B * hist.shape[1] * 4
        b_ms, b_by = bound(n_bytes, 2 * int(valid.sum()) * E)
        print(f"[kernel] pooled_lookup_staged B={B} F={hist.shape[1]} E={E}"
              f" valid={int(valid.sum())} rows={n_rows}: max err {err:.3g},"
              f" {ms:.4f} ms (call {call_ms:.4f}), plain {plain_ms:.4f} ms"
              f" (call {plain_call:.4f}), bound {b_ms:.6f} ms ({b_by})")
        if B == 16:
            rec["pooled_lookup_staged"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
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


def phase_train(seed: int, codec=None) -> dict:
    from repro_torch.launch.train import build_parser, run_dlrm

    argv = TRAIN_ARGV + ["--seed", str(seed)]
    if codec is not None:
        argv += ["--codec", codec]
    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = run_dlrm(args)    # raises if a step's exchange overflowed
    launches = {k: v for k, v in _read_launches().items() if v}
    recs = out["metrics"]
    per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
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
    check(per_step.get("pooled_lookup") == 4.0,
          "pooled_lookup launched once per worker and step (decide)")
    if codec is None:
        check(per_step.get("gather_rows") == 12.0,
              "gather_rows packs ids, dense features and labels per worker")
    else:
        check(per_step.get("gather_rows") == 8.0,
              "gather_rows packs ids and labels per worker and step")
        check(per_step.get("gather_rows_quant") == 4.0,
              "gather_rows_quant packs the dense features per worker")
    check(all(np.isfinite(losses)), "every training loss finite")
    check(all(r["miss_pull"] > 0 for r in recs), "miss_pull > 0 each step")
    return launches


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
    return rec


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
    n0 = A.LAUNCHES["auction_bids"]
    card = simulate(SimConfig(device="cuda", **base))
    rounds = A.LAUNCHES["auction_bids"] - n0
    cpu = simulate(SimConfig(device="cpu", **base))
    for f in ("per_iter_cost", "alg1_cost", "ingredient", "hit_ratio",
              "cost"):
        a, b = getattr(card, f), getattr(cpu, f)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        check(same, f"simulate(opt='auction') {f} equal on card and CPU")
    check(rounds > 0, "the card's simulate launched the bid kernel")
    print(f"[parity] simulate tiny, 4 workers x 8, opt auction, 4 "
          f"iterations, card vs CPU: per_iter_cost, alg1_cost, ingredient, "
          f"hit_ratio equal; cost {card.cost!r}; {rounds} rounds on the card")
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
    total_rounds = 0
    for bpw, cost in costs.items():
        before = _read_launches()["auction_bids"]
        assign, rounds = auction_dispatch(cost, bpw, exact=False,
                                          device="cuda", return_rounds=True)
        launched = _read_launches()["auction_bids"] - before
        check(launched == rounds, f"table 2 bpw {bpw}: bid-kernel launches "
                                  f"({launched}) equal rounds ({rounds})")
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
        total_rounds += 4 * rounds
        print(f"[table2] bpw {bpw} (k = {8 * bpw}, n = 8): {rounds} rounds, "
              f"{statistics.median(times):.3f} ms per decision (median of "
              f"3 after a warm call; {statistics.median(times) / rounds:.4f} "
              f"ms a round), {launched} bid-kernel launches; paper's "
              f"CUDA Hungarian {PAPER_TABLE2_MS[bpw]} ms")
    launches = {k: v for k, v in _read_launches().items() if v}
    check(launches.get("auction_bids") == total_rounds,
          "table 2: bid-kernel launches equal the rounds of its calls")
    return launches


def phase_simulate(seed: int) -> dict:
    """The paper's simulator at S1 on the card, each mechanism in turn."""
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.serve import ServeKnobs, simulate_serve

    base = dict(workload=WORKLOADS["S1"], n_workers=8, batch_per_worker=32,
                cache_ratio=0.08, embedding_dim=512, iters=8, warmup=2,
                seed=seed, decision_model="measured", device="cuda")
    launches: dict = {}
    costs = {}
    for name, kw in (("esd-auction", dict(mechanism="esd", opt="auction")),
                     ("esd-ssp", dict(mechanism="esd", opt="ssp")),
                     ("laia", dict(mechanism="laia")),
                     ("het", dict(mechanism="het")),
                     ("fae", dict(mechanism="fae")),
                     ("random", dict(mechanism="random"))):
        _zero_launches()
        t = time.perf_counter()
        res = simulate(SimConfig(**base, **kw))
        wall = time.perf_counter() - t
        run = {k: v for k, v in _read_launches().items() if v}
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        bids = run.get("auction_bids", 0)
        check(bool(np.isfinite(res.per_iter_cost).all())
              and len(res.per_iter_cost) == 6 and 0 <= res.hit_ratio <= 1,
              f"simulate {name}: six finite iteration costs, hit ratio in "
              f"[0, 1]")
        check((bids > 0) == (name == "esd-auction"),
              f"simulate {name}: the bid kernel runs only for the auction")
        costs[name] = res.cost
        print(f"[simulate] S1 {name}: cost {res.cost!r} s, itps "
              f"{res.itps!r}, hit ratio {res.hit_ratio!r}, decision "
              f"{res.decision_time_mean * 1e3:.3f} ms (mean of iterations "
              f"2-7), bid-kernel launches {bids} = rounds "
              f"({bids / base['iters']:.1f} per decision), wall {wall:.1f} s")
    check(costs["esd-auction"] < costs["random"],
          "ESD with the auction moves less than random dispatch")
    _zero_launches()
    res = simulate_serve(SimConfig(
        workload=WORKLOADS["S1"], n_workers=8, opt="auction", seed=seed,
        device="cuda", serve=ServeKnobs(qps=2000.0, duration_s=0.5)))
    run = {k: v for k, v in _read_launches().items() if v}
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v
    check(run.get("auction_bids", 0) > 0 and res.n_requests > 0
          and np.isfinite(res.p99_s),
          "simulate_serve with the auction served the stream through the "
          "bid kernel")
    print(f"[simulate] serve S1, 8 workers, 2,000 QPS for 0.5 s, opt "
          f"auction: p50 {res.p50_s * 1e3:.4f} ms, p99 "
          f"{res.p99_s * 1e3:.4f} ms, slo_violation_rate "
          f"{res.slo_violation_rate:.4f}, {res.n_requests} requests in "
          f"{res.n_batches} batches, bid-kernel launches "
          f"{run.get('auction_bids', 0)}")
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
    phase_parity(args.seed)
    phase_train_parity(args.seed)
    phase_train_parity(args.seed, codec="int8")
    phase_sim_parity(args.seed)
    # launches on the main paths: each run counted from zero, then summed
    launches: dict = {}
    for run in (lambda: phase_serve(args.seed),
                lambda: phase_serve(args.seed, codec="int8", duration=0.5),
                lambda: phase_train(args.seed),
                lambda: phase_train(args.seed, codec="int8"),
                phase_table2,
                lambda: phase_simulate(args.seed)):
        t = time.perf_counter()
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
        print(f"[wall] phase took {time.perf_counter() - t:.1f} s")
    # B5 runs on no driver path (its phase 3 check holds it); every other
    # kernel must have launched on a main path
    for k in SOURCES:
        check(k == "pooled_lookup_quant" or launches.get(k, 0) > 0,
              f"{k} launched on a main path")
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
