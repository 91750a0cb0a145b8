"""The dry run: every (arch x input shape) on the production mesh,
described without a card, for its per-device state bytes and FLOPs.

The counterpart of the JAX package's ``launch/dryrun.py``, with its
flags and record keys.  The reference lowers and compiles each step
under XLA on 512 host devices; the port has no compiler to ask, so:

  * the full config gives ``attn_mode`` and ``state_bytes_per_device``:
    the analytic bytes of the parameters plus the optimizer state
    (train) or plus the decode cache (decode), each leaf divided by the
    devices its spec shards it over (:mod:`repro_torch.dist.sharding`);
  * FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
    while the step runs on the ``meta`` device at the shape's global
    batch (train: forward, backward and the remat recompute, the
    optimizer's elementwise work uncounted; prefill and decode: the
    forward).  On ``meta`` every kernel wrapper takes its plain version,
    so the count is the function's, not a kernel's.  The 1- and 2-group
    probes are counted under ``scan_config.UNROLL`` and give
    ``cost_analysis_extrapolated`` as the reference's do, per device
    (the count over the mesh's device count).  Only ``flops`` is counted
    (no bytes accessed, no transcendentals).  The full config is not
    counted: the port loops over its layers, so a full count equals the
    extrapolation on a homogeneous stack (the tests hold that) and would
    only cost time (a few hundred microseconds an operation on meta);
  * what only XLA reports (``memory_analysis``, the full config's
    ``cost_analysis``, the HLO's ``collectives``, ``hlo_bytes``,
    ``lower_s`` and ``compile_s``) is recorded as the string
    ``"unavailable: ..."``, the reference's own form when a backend
    reports nothing.

Usage (no card needed; nothing is allocated):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Records go to ``benchmarks/results_torch/`` (``{mesh}_{arch}_{shape}
{tag}.json``).  Importing this module sets no environment variable and
touches no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from torch import nn

from ..configs import ARCH_IDS, CONFIGS, INPUT_SHAPES
from ..dist import ctx
from ..dist.sharding import (cache_specs, opt_state_specs, param_specs,
                             tree_map)
from ..models import scan_config
from .mesh import make_production_mesh
from .steps import (input_specs, make_prefill_step, make_serve_step,
                    make_train_step)

__all__ = ["RESULTS_DIR", "should_skip", "run_dryrun", "save", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / \
    "results_torch"

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_EXTRAP_COST_KEYS = ("flops", "bytes accessed", "transcendentals")
_NO_XLA = "unavailable: the port has no XLA compile to report it"
_PROBES_ONLY = ("unavailable: FLOPs are counted on the 1- and 2-group "
                "probes (cost_analysis_extrapolated)")
_NO_HLO = ("unavailable: no HLO to parse (one card, nothing partitioned: "
           "ROADMAP A14.9)")


def should_skip(arch: str, shape_name: str) -> str | None:
    """The reference's documented skips."""
    cfg = CONFIGS[arch]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md)")
    return None


def _leaves(tree) -> list:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    out: list = []
    tree_map(lambda _, x: out.append(x), tree)
    return out


def _analytic_device_bytes(tree_shapes, specs, mesh) -> float:
    """Exact per-device bytes of a tree of (meta) tensors under its
    specs."""
    axis = mesh.shape
    total = 0.0
    for t, spec in zip(_leaves(tree_shapes), _leaves(specs), strict=True):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for nm in names:
                shards *= axis[nm]
        total += (t.numel() * t.element_size() / shards if t.dim()
                  else t.element_size())
    return float(total)


def _count_flops(cfg, spec: dict, remat: bool) -> int:
    """FLOPs of one step on the ``meta`` tensors of ``spec``."""
    from torch.utils.flop_counter import FlopCounterMode

    kind = spec["shape"].kind
    params = spec["params"]
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            make_train_step(cfg, params, spec["optimizer"],
                            remat=remat)(spec["batch"])
        elif kind == "prefill":
            make_prefill_step(cfg, remat=remat)(params, spec["batch"])
        else:
            make_serve_step(cfg)(params, spec["cache"], spec["token"], 0)
    return counter.get_total_flops()


def _measure(cfg, shape_name: str, multi_pod: bool, remat: bool,
             count: bool = False) -> dict:
    """One config's specs and state bytes, and with ``count`` its FLOPs
    a device, on ``meta``."""
    shape = INPUT_SHAPES[shape_name]
    rec: dict = {}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec["attn_mode"] = ctx.set_attention_specs(cfg, mesh)
    try:
        spec = input_specs(cfg, shape_name)
        params = spec["params"]
        pspecs = param_specs(params, cfg)
        state_bytes = _analytic_device_bytes(params, pspecs, mesh)
        if shape.kind == "train":
            ospecs = opt_state_specs(spec["opt_state"], params, cfg)
            state_bytes += _analytic_device_bytes(spec["opt_state"], ospecs,
                                                  mesh)
        elif shape.kind == "decode":
            cspecs = cache_specs(cfg, spec["cache"], mesh,
                                 shape.global_batch)
            state_bytes += _analytic_device_bytes(spec["cache"], cspecs,
                                                  mesh)
        flops = _count_flops(cfg, spec, remat) if count else None
    finally:
        ctx.clear()

    rec["lower_s"] = _NO_XLA
    rec["compile_s"] = _NO_XLA
    rec["state_bytes_per_device"] = state_bytes
    rec["memory_analysis"] = _NO_XLA
    rec["cost_analysis"] = (_PROBES_ONLY if flops is None
                            else {"flops": float(flops) / mesh.size})
    rec["collectives"] = _NO_HLO
    rec["hlo_bytes"] = _NO_HLO
    return rec


def _probe_cfg(cfg, groups: int):
    P = len(cfg.layer_pattern)
    repl = {"n_layers": P * groups}
    if cfg.encoder_layers:
        repl["encoder_layers"] = groups
    return dataclasses.replace(cfg, **repl)


def _group_multiplier(cfg) -> float:
    P = len(cfg.layer_pattern)
    return cfg.n_layers // P + (cfg.n_layers % P) / P


def _extrapolate(m1: dict, m2: dict, mult: float) -> dict:
    """extrap = m1 + (m2 - m1) * (mult - 1), over the cost metrics
    present and the collectives where both probes have them (else their
    ``"unavailable: ..."`` string)."""
    out = {}
    c1, c2 = m1.get("cost_analysis"), m2.get("cost_analysis")
    if isinstance(c1, dict) and isinstance(c2, dict):
        out["cost_analysis"] = {
            k: c1.get(k, 0.0) + (c2.get(k, 0.0) - c1.get(k, 0.0)) * (mult - 1)
            for k in _EXTRAP_COST_KEYS if k in c1
        }
    cl1, cl2 = m1["collectives"], m2["collectives"]
    if not (isinstance(cl1, dict) and isinstance(cl2, dict)):
        out["collectives"] = cl1 if isinstance(cl1, str) else cl2
        return out
    col = {}
    for op in _COLLECTIVES:
        b1, b2 = cl1[op]["bytes"], cl2[op]["bytes"]
        n1, n2 = cl1[op]["count"], cl2[op]["count"]
        col[op] = {
            "bytes": b1 + (b2 - b1) * (mult - 1),
            "count": n1 + (n2 - n1) * (mult - 1),
        }
    col["total_bytes"] = sum(v["bytes"] for v in col.values()
                             if isinstance(v, dict))
    out["collectives"] = col
    return out


def run_dryrun(arch: str, shape_name: str, multi_pod: bool = False,
               remat: bool = True, verbose: bool = True,
               probes: bool = True) -> dict:
    """One (arch, shape) record on the 16x16 mesh (2x16x16 with
    ``multi_pod``)."""
    cfg = CONFIGS[arch]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "family": cfg.family, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    skip = should_skip(arch, shape_name)
    if skip:
        rec["skipped"] = skip
        return rec

    t0 = time.perf_counter()
    rec.update(_measure(cfg, shape_name, multi_pod, remat))

    if probes:
        # the 1- and 2-group probes, with the inner loops' blocks and
        # chunks grown as the reference's probes grow them
        scan_config.UNROLL = True
        try:
            m1 = _measure(_probe_cfg(cfg, 1), shape_name, multi_pod, remat,
                          count=True)
            m2 = _measure(_probe_cfg(cfg, 2), shape_name, multi_pod, remat,
                          count=True)
        finally:
            scan_config.UNROLL = False
        ext = _extrapolate(m1, m2, _group_multiplier(cfg))
        rec["cost_analysis_extrapolated"] = ext.get("cost_analysis")
        rec["collectives_extrapolated"] = ext["collectives"]
        rec["probe_compile_s"] = (m1.get("compile_s", 0),
                                  m2.get("compile_s", 0))

    if verbose:
        ca = (rec.get("cost_analysis_extrapolated")
              or rec.get("cost_analysis") or {})
        fl = ca.get("flops", 0) if isinstance(ca, dict) else 0
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"attn_mode={rec['attn_mode']} flops/dev={fl:.6g} "
              f"state/dev={rec['state_bytes_per_device'] / 2**30:.2f}GiB "
              f"({time.perf_counter() - t0:.1f} s on meta)", flush=True)
    return rec


def save(rec: dict, out_dir: Path, tag: str = ""):
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['mesh']}_{rec['arch']}_{rec['shape']}{tag}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the 1g/2g cost probes")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--tag", default="")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    combos = (
        [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
        if args.all else [(args.arch, args.shape)]
    )
    ok = True
    for arch, shape in combos:
        mesh = "2x16x16" if args.multi_pod else "16x16"
        out_file = args.out / f"{mesh}_{arch}_{shape}{args.tag}.json"
        if args.all and out_file.exists():
            print(f"[dryrun] skip existing {out_file.name}", flush=True)
            continue
        try:
            rec = run_dryrun(arch, shape, multi_pod=args.multi_pod,
                             remat=not args.no_remat,
                             probes=not args.no_probes)
        except Exception as e:
            print(f"[dryrun] FAIL {arch} x {shape}: {type(e).__name__}: {e}",
                  flush=True)
            ok = False
            continue
        save(rec, args.out, args.tag)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
