"""The serving history bag's kernel (B6, ``pooled_lookup_staged``) and
the pooled lookup over a quantized table (B5, ``pooled_lookup_quant``)
in several builds, in turns, in one process.

    python3 scripts/ab_staged.py [--other PATH] [--set NAME=VALUE ...] \
        [--reps 200]

Builds ``src/repro_torch/kernels/csrc/emb_lookup.cu`` of this checkout
as it is ("this"); once more for each ``--set NAME=VALUE``, with the
source's ``constexpr int NAME = ...;`` set to VALUE (e.g. ``--set
kBagBatch=16``, the row loads a lane keeps in flight, B6's and B5's);
and the same file of the checkout at ``--other`` (e.g. an earlier commit
unpacked with ``git archive``), each by ``nvcc`` with the package's
flags into ``build/ab_staged/``.  Then, on ``chip_smoke.py``'s inputs
(wdl-s1: V = 502,000, E = 512, the 23,564-row hot-set plane, bags of
the stream's 48 history slots at B = 16 and 4,096, seed 0), and on
``chip_smoke.phase_quant_kernels``'s shapes (an S1 batch of 256 x 74
over the int8-quantized wdl-s1 table at E = 512 and E = 4, seed 11; not
for ``--other``, whose B5 launcher may take other arguments), it checks
each build bit for bit against the plain versions and times them with
``chip_smoke.device_ms`` (median device ms of ``--reps`` calls), going
through the builds forwards and then backwards, so that a drift of the
card's clocks shows.  Prints the card's name and power limit, each
build's registers, the launch floor (an empty kernel) and the times.
Needs a CUDA device and ``nvcc``; exits non-zero without them or when a
build disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "src/repro_torch/kernels/csrc/emb_lookup.cu"


def _variant(text: str, assignment: str) -> str:
    name, value = assignment.split("=")
    pattern = rf"(constexpr int {name} = )[^;]+;"
    if not re.search(pattern, text):
        raise SystemExit(f"ab_staged: no constexpr int {name} in {SOURCE}")
    return re.sub(pattern, rf"\g<1>{value};", text, count=1)


def _build_all(sources: dict, out_dir: Path) -> dict:
    """nvcc every source at once; the libraries bound as _build binds
    them, and each kernel's register line."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs.append((name, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"ab_staged: nvcc failed on {name}:\n{err}")
        entry = ""
        for ln in err.splitlines():
            if "Compiling entry function" in ln:
                entry = re.findall(r"'([^']+)'", ln)[0]
            elif "registers" in ln and ("pooled_lookup_staged" in entry
                                        or "pooled_lookup_bag" in entry):
                print(f"[ab] {name} {entry}: "
                      f"{ln.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES["emb_lookup"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--set", action="append", default=[], dest="sets")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_staged: no CUDA device")
    import chip_smoke as cs
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import _build
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.pipeline.prefetch import PrefetchPlane, slot_map
    from repro_torch.quant.codecs import quantize_rows
    from repro_torch.serve.sim import _hot_set

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    text = (ROOT / SOURCE).read_text()
    sources = {"this": text}
    for s in args.sets:
        sources[s.replace("=", "-")] = _variant(text, s)
    if args.other is not None:
        sources["other"] = (args.other / SOURCE).read_text()
    libs = _build_all(sources, ROOT / "build" / "ab_staged")

    # chip_smoke.phase_kernels's inputs
    wl = WORKLOADS["S1"]
    V, E, F = wl.vocab, 512, wl.n_fields
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    table = torch.randn((V, E), generator=g, device=dev) * 0.01
    hot = _hot_set(wl, np.random.default_rng(1), 2048, int(0.25 * V))
    C = len(hot)
    plane_rows = torch.randn((C, E), generator=g, device=dev) * 0.01
    plane = PrefetchPlane(
        ids=torch.as_tensor(hot.astype(np.int32), device=dev),
        rows=plane_rows,
        expiry=torch.full((C,), 1, dtype=torch.int32, device=dev))
    smap = slot_map(plane, V, 0)
    bags = {}
    for B in (16, 4096):
        ids = torch.as_tensor(wl.sample_batch(rng, B)[:, F:]
                              .astype(np.int32), device=dev)
        bags[B] = (ids, torch.where(ids >= 0,
                                    smap[ids.long().clamp(min=0)], -1))
    # chip_smoke.phase_quant_kernels's shapes
    g5 = torch.Generator(device=dev).manual_seed(11)
    rng5 = np.random.default_rng(11)
    q_ids = torch.as_tensor(wl.sample_batch(rng5, 256).astype(np.int32),
                            device=dev)
    q_w = torch.rand(q_ids.shape, generator=g5, device=dev)
    quant = {Eq: quantize_rows(torch.randn((V, Eq), generator=g5,
                                           device=dev) * 0.01, "int8")
             for Eq in (512, 4)}
    floor, floor_call = cs.device_ms(lambda: libs["this"].empty_launch(
        torch.cuda.current_stream().cuda_stream), reps=args.reps)
    print(f"[ab] launch floor (an empty kernel): {floor:.4f} ms (call "
          f"{floor_call:.4f})")
    times: dict = {}
    rc = 0
    for name in list(libs) + list(libs)[::-1]:
        _build._loaded["emb_lookup"] = libs[name]
        for B, (ids, slots) in bags.items():
            out = K.pooled_lookup_staged(plane_rows, table, slots, ids)
            ref = K.pooled_lookup_staged_ref(plane_rows, table, slots, ids)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"[ab] {name} B={B}: differs from the plain version")
                rc = 1
            ms, _ = cs.device_ms(lambda: K.pooled_lookup_staged(
                plane_rows, table, slots, ids), reps=args.reps)
            times.setdefault(("pooled_lookup_staged", name, f"B={B}"),
                             []).append(ms)
        # B5's launcher took other arguments before this checkout: its
        # builds of --other are timed by scripts/ab_advance.py instead
        for Eq, (codes, scale, zp) in (quant.items() if name != "other"
                                       else ()):
            qargs = (codes, scale, zp, q_ids, q_w)
            out = K.pooled_lookup_quant(*qargs, codec="int8")
            ref = K.pooled_lookup_quant_ref(*qargs, codec="int8")
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"[ab] {name} quant E={Eq}: differs from the plain "
                      f"version")
                rc = 1
            ms, _ = cs.device_ms(lambda: K.pooled_lookup_quant(
                *qargs, codec="int8"), reps=args.reps)
            times.setdefault(("pooled_lookup_quant", name, f"E={Eq}"),
                             []).append(ms)
    for (kernel, name, shape), ms in times.items():
        print(f"[ab] {kernel} {name} {shape}: "
              f"{', '.join(f'{x:.4f}' for x in ms)} ms (forwards, "
              f"backwards)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
