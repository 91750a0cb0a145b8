"""repro_torch.launch.dryrun, the meta-device shape helpers of
``launch.steps`` and the kernels' meta routing, on the CPU against the
JAX package's.

- ``input_specs``' shapes and dtypes against the reference's for every
  arch x input shape (the port's per-layer parameters and caches against
  the reference's stacked leaves through ``ref_paths``);
- ``should_skip``, ``_probe_cfg``, ``_group_multiplier`` and
  ``_extrapolate`` against the reference's;
- ``state_bytes_per_device`` on the 16x16 and 2x16x16 meshes equal,
  exactly, to the reference's ``_analytic_device_bytes`` over its own
  specs, for every arch x shape;
- at homogeneous smoke configs the 1- and 2-group probes' FLOPs,
  extrapolated, equal a full-depth meta count exactly (train with its
  remat recompute, prefill, decode);
- ``main --arch --shape --out`` writes one record with the reference's
  keys; importing the module leaves ``os.environ`` as it was;
- ``meta`` tensors take every kernel wrapper's plain version, any other
  device than the CPU, meta and CUDA raises, and a meta train step and
  decode step of every smoke arch run.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when imported: the fixture that imports it puts the variable
back, so later JAX subprocesses of this worker see the real device
count.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import CONFIGS as J_CONFIGS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.dist import sharding as js
from repro.launch import steps as jsteps
from repro_torch.configs import ARCH_IDS, CONFIGS, INPUT_SHAPES, SMOKE_CONFIGS
from repro_torch.kernels import emb_lookup, flash_attn, linear_scan
from repro_torch.launch import dryrun, steps
from repro_torch.models import api, backbone, whisper
from repro_torch.optim import adam

ROOT = Path(__file__).resolve().parents[1]
# the reference's record keys (its run_dryrun and _measure)
RECORD_KEYS = {"arch", "shape", "mesh", "family", "params", "active_params",
               "attn_mode", "lower_s", "compile_s", "state_bytes_per_device",
               "memory_analysis", "cost_analysis", "collectives",
               "hlo_bytes", "cost_analysis_extrapolated",
               "collectives_extrapolated", "probe_compile_s"}
# state_bytes_per_device of arch x train_4k on 16x16 (the reference's)
TRAIN_BYTES = {"smollm-360m": 964_128_004,
               "falcon-mamba-7b": 4_383_096_836,
               "llama4-scout-17b-a16e": 95_673_364_484,
               "phi3.5-moe-42b-a6.6b": 38_756_270_084}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, with ``XLA_FLAGS`` put back."""
    old = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


_JSHAPES: dict = {}


@pytest.fixture
def cached_ref_shapes(monkeypatch):
    """The reference's ``param_shapes`` once per config (its
    ``input_specs`` asks for them per shape)."""
    plain = jsteps.param_shapes

    def cached(cfg):
        if cfg not in _JSHAPES:
            _JSHAPES[cfg] = plain(cfg)
        return _JSHAPES[cfg]

    monkeypatch.setattr(jsteps, "param_shapes", cached)


def _same(t, leaf, stacked=False):
    shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
    assert tuple(t.shape) == shape, (t.shape, leaf.shape)
    assert t.dtype == DTYPES[np.dtype(leaf.dtype).name]
    assert t.device.type == "meta"


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(model, cfg):
    if isinstance(model, whisper.Whisper):
        return whisper.ref_paths(model, cfg)
    return backbone.ref_paths(model, cfg)


def _cache_pairs(cfg, cache):
    if isinstance(cache, dict):                         # whisper
        out = [(("self", j, k), ("self", k), j)
               for j, layer in enumerate(cache["self"]) for k in layer]
        return out + [((k,), (k,), None) for k in ("cross_k", "cross_v")]
    n_groups, gkinds, _ = backbone.group_layout(cfg)
    P_ = len(gkinds)
    return [((j, k), ("groups", f"l{j % P_}", k), j // P_)
            if j < n_groups * P_ else
            ((j, k), ("rest", f"l{j - n_groups * P_}", k), None)
            for j, layer in enumerate(cache) for k in layer]


# --------------------------------------------------------------------------
# the shape helpers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, cached_ref_shapes):
    for name in INPUT_SHAPES:
        got = steps.input_specs(CONFIGS[arch], name)
        want = jsteps.input_specs(J_CONFIGS[arch], name)
        assert set(got) == set(want), name
        assert got["shape"] == INPUT_SHAPES[name]
        cfg, model = CONFIGS[arch], got["params"]
        paths = _paths(model, cfg)
        params = list(model.parameters())
        assert len(params) == len(paths)
        for p, (path, at) in zip(params, paths):
            _same(p, _get(want["params"], path), at is not None)
        if "opt_state" in got:
            for k in ("mu", "nu"):
                for t, (path, at) in zip(got["opt_state"][k], paths):
                    _same(t, _get(want["opt_state"][k], path), at is not None)
            _same(got["opt_state"]["t"], want["opt_state"]["t"])
        if "batch" in got:
            assert set(got["batch"]) == set(want["batch"])
            for k, t in got["batch"].items():
                _same(t, want["batch"][k])
        if "cache" in got:
            for mine, theirs, at in _cache_pairs(cfg, got["cache"]):
                _same(_get(got["cache"], mine), _get(want["cache"], theirs),
                      at is not None)
            _same(got["token"], want["token"])
            _same(got["pos"], want["pos"])


# --------------------------------------------------------------------------
# the dry run's parts
# --------------------------------------------------------------------------
def test_should_skip_probe_cfg_and_multiplier_match_reference(jdry):
    for arch in ARCH_IDS:
        for name in INPUT_SHAPES:
            assert dryrun.should_skip(arch, name) == \
                jdry.should_skip(arch, name)
        for g in (1, 2, 3):
            assert dataclasses.asdict(dryrun._probe_cfg(CONFIGS[arch], g)) \
                == dataclasses.asdict(jdry._probe_cfg(J_CONFIGS[arch], g))
        assert dryrun._group_multiplier(CONFIGS[arch]) == \
            jdry._group_multiplier(J_CONFIGS[arch])


def _record(rng, with_collectives=True):
    rec = {"cost_analysis": {"flops": float(rng.integers(1, 10**9)),
                             "bytes accessed": float(rng.integers(1, 10**6))}}
    if with_collectives:
        col = {op: {"count": int(rng.integers(0, 9)),
                    "bytes": float(rng.integers(0, 10**6))}
               for op in dryrun._COLLECTIVES}
        col["total_bytes"] = sum(v["bytes"] for v in col.values())
        rec["collectives"] = col
    else:
        rec["collectives"] = "unavailable: none"
    return rec


@pytest.mark.parametrize("mult", [1.0, 2.0, 8.666666666666666, 64.0])
def test_extrapolate_matches_reference(mult, jdry):
    rng = np.random.default_rng(int(mult * 3))
    m1, m2 = _record(rng), _record(rng)
    assert dryrun._extrapolate(m1, m2, mult) == jdry._extrapolate(m1, m2,
                                                                  mult)
    m1, m2 = _record(rng, False), _record(rng, False)
    m1["cost_analysis"] = {"flops": 10.0}
    m2["cost_analysis"] = {"flops": 16.0}
    out = dryrun._extrapolate(m1, m2, mult)
    assert out["cost_analysis"] == {"flops": 10.0 + 6.0 * (mult - 1)}
    assert out["collectives"] == "unavailable: none"


def _ref_state_bytes(jdry, arch, name, mesh_name):
    """The reference's ``_measure`` state bytes, without its lowering."""
    cfg, shape = J_CONFIGS[arch], J_SHAPES[name]
    sizes, names = MESHES[mesh_name]
    mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(sizes))
    spec = jsteps.input_specs(cfg, name)
    total = jdry._analytic_device_bytes(
        spec["params"], js.param_specs(spec["params"], cfg), mesh)
    if shape.kind == "train":
        total += jdry._analytic_device_bytes(
            spec["opt_state"], js.param_specs(spec["opt_state"], cfg), mesh)
    elif shape.kind == "decode":
        total += jdry._analytic_device_bytes(
            spec["cache"], js.cache_specs(cfg, spec["cache"],
                                          JMesh(sizes, names),
                                          shape.global_batch), mesh)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_bytes_equal_the_reference_analytic_bytes(arch, jdry,
                                                        cached_ref_shapes):
    for name in INPUT_SHAPES:
        if dryrun.should_skip(arch, name):
            continue
        for mesh_name in MESHES if name == "train_4k" else ("16x16",):
            got = dryrun._measure(CONFIGS[arch], name,
                                  mesh_name == "2x16x16", True)
            want = _ref_state_bytes(jdry, arch, name, mesh_name)
            assert got["state_bytes_per_device"] == want, (name, mesh_name)
            if name == "train_4k" and mesh_name == "16x16" \
                    and arch in TRAIN_BYTES:
                assert got["state_bytes_per_device"] == TRAIN_BYTES[arch]
            assert got["attn_mode"] == js.ctx.attn_mode(J_CONFIGS[arch], 16)


@pytest.mark.parametrize("arch,n_layers", [("smollm-360m", 4),
                                           ("falcon-mamba-7b", 3),
                                           ("whisper-large-v3", 3)])
@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_probes_extrapolate_to_the_full_depth_count(arch, n_layers, name):
    """A homogeneous smoke stack: the 1- and 2-group counts under UNROLL,
    extrapolated, are the full-depth count, exactly."""
    over = {"n_layers": n_layers}
    if arch == "whisper-large-v3":
        over["encoder_layers"] = n_layers
    cfg = dataclasses.replace(SMOKE_CONFIGS[arch], **over)

    def count(c):
        return dryrun._count_flops(c, steps.input_specs(c, name), True)

    full = count(cfg)
    dryrun.scan_config.UNROLL = True
    try:
        f1, f2 = count(dryrun._probe_cfg(cfg, 1)), \
            count(dryrun._probe_cfg(cfg, 2))
    finally:
        dryrun.scan_config.UNROLL = False
    mult = dryrun._group_multiplier(cfg)
    assert mult == n_layers and f2 > f1 > 0
    assert f1 + (f2 - f1) * (n_layers - 1) == full
    ext = dryrun._extrapolate({"cost_analysis": {"flops": f1 / 256},
                               "collectives": dryrun._NO_HLO},
                              {"cost_analysis": {"flops": f2 / 256},
                               "collectives": dryrun._NO_HLO}, mult)
    assert ext["cost_analysis"]["flops"] == pytest.approx(full / 256,
                                                          rel=1e-12)


def test_main_writes_one_record(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--out", str(tmp_path), "--tag", "_t"])
    assert e.value.code == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["16x16_smollm-360m_decode_32k_t.json"]
    rec = json.loads(files[0].read_text())
    assert set(rec) == RECORD_KEYS
    assert rec["attn_mode"] == "seq" and rec["family"] == "dense"
    assert rec["cost_analysis_extrapolated"]["flops"] > 0
    for k in ("memory_analysis", "collectives", "hlo_bytes", "lower_s",
              "compile_s", "cost_analysis", "collectives_extrapolated"):
        assert rec[k].startswith("unavailable: "), k
    assert "[dryrun] smollm-360m x decode_32k x 16x16" in \
        capsys.readouterr().out
    skipped = dryrun.run_dryrun("smollm-360m", "long_500k", verbose=False)
    assert skipped["skipped"].startswith("full-attention arch")


def test_import_leaves_the_environment_alone():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "print(json.dumps(dict(os.environ) == before))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "true"


# --------------------------------------------------------------------------
# meta routing
# --------------------------------------------------------------------------
class _On:
    def __init__(self, device):
        self.device = torch.device(device)


def test_meta_takes_the_plain_version_and_other_devices_raise():
    assert emb_lookup._on_cuda(_On("meta"), _On("meta")) is False
    assert emb_lookup._on_cuda(_On("cpu")) is False
    for dev in ("xpu", "mps", "hpu"):
        with pytest.raises(ValueError, match=f"no kernel for device {dev}"):
            emb_lookup._on_cuda(_On(dev))
    with pytest.raises(ValueError, match="several devices"):
        emb_lookup._on_cuda(_On("meta"), _On("cpu"))
    n0 = (dict(emb_lookup.LAUNCHES), dict(flash_attn.LAUNCHES),
          dict(linear_scan.LAUNCHES))
    table = torch.empty((100, 16), device="meta")
    ids = torch.empty((8, 5), dtype=torch.int32, device="meta")
    assert emb_lookup.pooled_lookup(table, ids).shape == (8, 16)
    q = torch.empty((1, 2048, 2, 2, 64), device="meta")
    k = torch.empty((1, 2048, 2, 64), device="meta")
    out, lse = flash_attn.flash_attention(q, k, k)
    assert out.device.type == "meta" and tuple(lse.shape) == (1, 2, 2, 2048)
    a = torch.empty((2, 64, 8), device="meta")
    h, last = linear_scan.linear_scan(a, a, torch.empty((2, 8),
                                                        device="meta"))
    assert h.shape == a.shape and last.shape == (2, 8)
    assert (dict(emb_lookup.LAUNCHES), dict(flash_attn.LAUNCHES),
            dict(linear_scan.LAUNCHES)) == n0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_train_and_decode_steps_run(arch):
    """Every smoke arch's remat train step at S 2,048 (B8's route where
    it applies) and a decode step, on ``meta``."""
    cfg = SMOKE_CONFIGS[arch]
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=2048,
                                global_batch=2)
    model = steps.param_shapes(cfg)
    step = steps.make_train_step(cfg, model, adam(1e-3))
    loss = step(steps.batch_shapes(cfg, shape))
    assert loss.device.type == "meta" and loss.shape == ()
    cache = steps.cache_shapes(cfg, dataclasses.replace(
        INPUT_SHAPES["decode_32k"], seq_len=64, global_batch=2))
    token, _ = steps.decode_input_shapes(cfg, dataclasses.replace(
        INPUT_SHAPES["decode_32k"], global_batch=2))
    logits, _ = api.decode_step(model, cfg, token, cache, 3)
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    assert logits.device.type == "meta"
