"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own line:

1. device — the card's name and ``nvidia-smi``'s name and power limit;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving path's shapes (wdl-s1: V = 502,000, E = 512, the hot-set
   plane of C rows, bags of the synthetic stream's 48 history slots), with
   its median time, the plain version's and the least time the card could
   take (bytes over 3.35 TB/s, or flops over 67 TFLOP/s f32);
4. parity — the serve step and a TTL refresh on the card against the same
   calls on the CPU at wdl-tiny size;
5. serve — ``run_serve`` at wdl-s1 (4 workers, 2,000 QPS for 1 s), with the
   kernels' launch counters set to 0 just before and read just after.

Then one JSON line of kernel records, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; it also fails without a CUDA device and when the
package is not beside it.
"""
from __future__ import annotations

import argparse
import copy
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
SOURCE = "src/repro_torch/kernels/csrc/emb_lookup.cu"
REPLACES = {"staged_gather": "src/repro/kernels/emb_lookup.py:174",
            "pooled_lookup_staged": "src/repro/kernels/emb_lookup.py:245"}


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

    t = time.perf_counter()
    _build.load_library("emb_lookup")
    dt = time.perf_counter() - t
    ptxas = [ln.strip() for ln in _build.build_log("emb_lookup").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] emb_lookup in {dt:.2f} s; " + " | ".join(ptxas))


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


def phase_serve(seed: int) -> tuple[dict, dict]:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.launch.serve import build_parser, run_serve
    from repro_torch.serve import StreamConfig, request_arrivals

    argv = ["--arch", "wdl-s1", "--workers", "4", "--qps", "2000",
            "--duration", "1", "--max-batch", "16", "--ttl-batches", "32",
            "--refresh-budget", "64", "--device", "cuda",
            "--seed", str(seed)]
    args = build_parser().parse_args(argv)
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    out = run_serve(args)
    launches = dict(K.LAUNCHES)
    n_stream = len(request_arrivals(StreamConfig(
        workload=WORKLOADS["S1"], qps=2000.0, duration_s=1.0,
        seed=seed))[0])
    per_batch = {k: round(v / out["n_batches"], 3)
                 for k, v in launches.items()}
    print(f"[serve] wdl-s1: n_requests {out['n_requests']} in "
          f"{out['n_batches']} batches, p50 {out['p50_ms']:.3f} ms, "
          f"p99 {out['p99_ms']:.3f} ms, refresh_rows {out['refresh_rows']}, "
          f"slo_violation_rate {out['slo_violation_rate']:.4f}, decide "
          f"{out['decide_ms_mean']:.3f} ms/batch, worker step "
          f"{out['worker_step_ms_mean']:.3f} ms x {out['worker_steps']}; "
          f"launches {launches} ({per_batch} per micro-batch)")
    check(all(v > 0 for v in launches.values()),
          "both kernels launched on the serving path")
    check(out["n_requests"] == n_stream, "every request of the stream served")
    check(out["nonfinite_logits"] == 0, "all logits finite")
    check(out["refresh_rows"] > 0, "TTL refreshes happened")
    return out, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    rec = phase_kernels(args.seed)
    phase_parity(args.seed)
    _, launches = phase_serve(args.seed)
    kernels = [dict(name=k, route="cuda", source=SOURCE,
                    replaces=REPLACES[k], launches=launches[k],
                    library_ms=None, **rec[k])
               for k in ("staged_gather", "pooled_lookup_staged")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
