"""repro_torch.checkpoint on the CPU: its own behaviour, and checkpoints
carried between the two packages.

* The round trip of nested trees (dicts, lists, the cache-state
  dataclass; tensor, numpy and scalar leaves), discovery of the newest
  step, a leftover ``.tmp.npz`` never taken for a checkpoint and cleaned
  up by the next save, the fallback to an older archive when the newest
  is torn (never with an explicit step), and a missing leaf or a wrong
  shape raising with the leaf's path — as the reference's own tests
  hold it.
* bf16 leaves: stored as f32, restored as bf16, exact.
* Across packages: the reference's ``save_checkpoint`` of its DLRM tree
  (``init_params``, ``rowwise_adagrad``, ``esd_sparse_init``, ``qres``)
  and of an LM smoke tree with Adam (f32 and bf16) is restored by the
  port's driver tree (``train_tree`` / ``load_train_tree``), and the
  port's save of the same values is restored by the reference's
  ``restore_checkpoint``; both archives hold the same entries, and every
  value is equal (the SSM and hybrid smoke trees too: falcon-mamba's
  Mamba leaves, recurrentgemma's RG-LRU leaves grouped and rest).  The
  same for a PS-stacked run's tree (``--n-ps 2``) and a dense-engine
  run's (``--esd-engine dense``).
* ``run_dlrm`` with ``--n-ps`` and with ``--esd-engine dense``, at
  depth 1 and 2, resumed from a checkpoint: the uninterrupted run's
  records exactly; ``run_lm`` of falcon-mamba and recurrentgemma smoke
  likewise.
"""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.configs import DLRM_CONFIGS as J_DLRM
from repro.configs import get_config as j_get_config
from repro.core.dispatch_tpu import SparseEsdState as JSparseEsdState
from repro.core.dispatch_tpu import esd_sparse_init as j_esd_init
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.models import api as j_api
from repro.models import dlrm as j_dlrm
from repro.optim.optimizers import adam as j_adam
from repro.optim.optimizers import rowwise_adagrad as j_adagrad
from repro_torch import checkpoint as TCK
from repro_torch.configs import DLRM_CONFIGS, get_config
from repro_torch.core.dispatch import SparseEsdState, esd_sparse_init
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.steps import make_train_step as lm_train_step
from repro_torch.launch.train import make_train_step
from repro_torch.models import backbone, dlrm
from repro_torch.models.dlrm import bce_loss
from repro_torch.models.tree import opt_from_ref, opt_to_ref, to_numpy
from repro_torch.optim import adam, rowwise_adagrad

N = 4


def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3),
                       "b": np.linspace(0, 1, 3).astype(np.float64)},
            "layers": [{"w": torch.ones(2, 2, dtype=torch.int32)},
                       {"w": torch.zeros(3, dtype=torch.bool)}],
            "esd": esd_sparse_init(2, 10, 3, max_ids=4),
            "step_count": np.int32(7)}


def _equal(a, b):
    fa, fb = TCK._flatten(a), TCK._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, u), (_, v) in zip(fa, fb):
        assert isinstance(u, torch.Tensor) == isinstance(v, torch.Tensor), key
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and u.device == v.device, key
            assert torch.equal(u, v), key
        else:
            assert np.asarray(u).dtype == np.asarray(v).dtype, key
            np.testing.assert_array_equal(u, v, err_msg=key)


# --------------------------------------------------------------------------
# the port's own checkpoints
# --------------------------------------------------------------------------
def test_round_trip_newest(tmp_path):
    t = _tree()
    TCK.save_checkpoint(tmp_path, 3, t)
    TCK.save_checkpoint(tmp_path, 7, t)
    assert TCK.latest_step(tmp_path) == 7
    restored, step = TCK.restore_checkpoint(tmp_path, t)
    assert step == 7
    _equal(restored, t)
    assert isinstance(restored["esd"], SparseEsdState)
    with np.load(tmp_path / "ckpt_00000007.npz") as data:
        assert int(data["__step__"]) == 7
        assert {"params::w", "layers::1::w", "esd::slots", "esd::step",
                "step_count"} <= set(data.files)


def test_tmp_leftover_is_not_a_checkpoint(tmp_path):
    TCK.save_checkpoint(tmp_path, 2, _tree())
    (tmp_path / "ckpt_00000009.tmp.npz").write_bytes(b"partial")
    (tmp_path / "ckpt_latest.npz").write_bytes(b"not a checkpoint")
    assert TCK.latest_step(tmp_path) == 2
    _, step = TCK.restore_checkpoint(tmp_path, _tree())
    assert step == 2
    TCK.save_checkpoint(tmp_path, 4, _tree())
    assert list(tmp_path.glob("*.tmp.npz")) == []
    assert TCK.latest_step(tmp_path) == 4


def test_empty_dir(tmp_path):
    assert TCK.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        TCK.restore_checkpoint(tmp_path, _tree())


def _truncate(path):
    path.write_bytes(path.read_bytes()[:40])   # torn write, keeps PK magic


def test_torn_newest_falls_back(tmp_path):
    t = _tree()
    TCK.save_checkpoint(tmp_path, 4, t)
    _truncate(TCK.save_checkpoint(tmp_path, 6, t))
    with pytest.warns(RuntimeWarning, match="unreadable"):
        restored, step = TCK.restore_checkpoint(tmp_path, t)
    assert step == 4
    _equal(restored, t)
    with pytest.raises(zipfile.BadZipFile):
        TCK.restore_checkpoint(tmp_path, t, step=6)
    _truncate(tmp_path / "ckpt_00000004.npz")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError):
            TCK.restore_checkpoint(tmp_path, t)


def test_structural_errors_name_the_leaf(tmp_path):
    TCK.save_checkpoint(tmp_path, 1, _tree())
    TCK.save_checkpoint(tmp_path, 2, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match=r"params::w"):
        TCK.restore_checkpoint(tmp_path, bad)
    bad = _tree()
    bad["esd"] = esd_sparse_init(3, 10, 3, max_ids=4)
    with pytest.raises(ValueError, match=r"esd::latest"):
        TCK.restore_checkpoint(tmp_path, bad)
    wider = _tree()
    wider["extra_head"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="extra_head"):
        TCK.restore_checkpoint(tmp_path, wider)


def test_bf16_leaves(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    TCK.save_checkpoint(tmp_path, 1, {"x": x, "y": x[0].float()})
    with np.load(tmp_path / "ckpt_00000001.npz") as data:
        assert data["x"].dtype == np.float32
        np.testing.assert_array_equal(data["x"], x.float().numpy())
    got, _ = TCK.restore_checkpoint(tmp_path, {"x": torch.zeros_like(x),
                                               "y": torch.zeros(7)})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
def _fill(tree, seed):
    """Every leaf of a reference tree filled with seeded random values of
    its dtype (positive floats, so accumulators stay plausible)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.random(x.shape) < 0.5
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(-1, 50, x.shape).astype(x.dtype)
        return rng.random(x.shape).astype(np.float32).astype(x.dtype)

    return jax.tree.map(fill, tree)


def _ref_dlrm_tree(arch, seed):
    cfg = J_DLRM[arch]
    wl = J_WORKLOADS[cfg.workload]
    params = j_dlrm.init_params(jax.random.key(seed), cfg, wl)
    V = wl.vocab
    tree = {"params": params,
            "opt": j_adagrad(1e-2).init(params),
            "esd": j_esd_init(N, V, int(0.2 * V), max_ids=16 * wl.width),
            "qres": {k: jnp.zeros_like(params[k]) for k in ("embed", "wide")
                     if k in params}}
    tree = _fill(tree, seed)
    tree["params"] = jax.tree.map(np.asarray, params)
    return tree


def _port_dlrm(arch, seed):
    """The port's driver tree of a fresh run (the template a resume
    restores into), and what fills it."""
    cfg = DLRM_CONFIGS[arch]
    wl = WORKLOADS[cfg.workload]
    model = dlrm.init_params(cfg, wl, torch.Generator().manual_seed(seed),
                             "cpu")
    step = make_train_step(model, bce_loss, rowwise_adagrad(1e-2), "int8")
    V = wl.vocab
    esd = esd_sparse_init(N, V, int(0.2 * V), max_ids=16 * wl.width)
    return model, dlrm.ref_paths(model), step.state, esd


def _ref_equal(got, want):
    fg = jax.tree_util.tree_flatten_with_path(got)
    fw = jax.tree_util.tree_flatten_with_path(want)
    assert fg[1] == fw[1]
    for (path, g), (_, w) in zip(fg[0], fw[0]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("arch", ["wdl-tiny", "dcn-tiny"])
def test_dlrm_checkpoint_reference_to_port(arch, tmp_path):
    want = _ref_dlrm_tree(arch, seed=1)
    JCK.save_checkpoint(tmp_path, 5, want)
    model, paths, state, esd = _port_dlrm(arch, seed=2)
    params = list(model.parameters())
    tmpl = TCK.train_tree(params, paths, state, esd)
    restored, step = TCK.restore_checkpoint(tmp_path, tmpl)
    assert step == 5
    esd = TCK.load_train_tree(restored, params, paths, state)
    got = {"params": dlrm.params_to_jax(model),
           "opt": to_numpy(opt_to_ref(state["opt"], paths)),
           "esd": JSparseEsdState(*(getattr(esd, f.name).numpy()
                                    for f in dataclasses.fields(esd))),
           "qres": to_numpy(state["qres"])}
    _ref_equal(got, want)


@pytest.mark.parametrize("arch", ["wdl-tiny", "dcn-tiny"])
def test_dlrm_checkpoint_port_to_reference(arch, tmp_path):
    want = _ref_dlrm_tree(arch, seed=3)
    model = dlrm.params_from_jax(want["params"], DLRM_CONFIGS[arch])
    paths = dlrm.ref_paths(model)
    state = {"opt": opt_from_ref(jax.tree.map(torch.as_tensor, want["opt"]),
                                 paths),
             "qres": {k: torch.as_tensor(v) for k, v in want["qres"].items()}}
    esd = SparseEsdState(**{k: torch.as_tensor(np.asarray(v))
                            for k, v in dataclasses.asdict(
                                want["esd"]).items()})
    TCK.save_checkpoint(tmp_path / "port", 5, TCK.train_tree(
        list(model.parameters()), paths, state, esd))
    JCK.save_checkpoint(tmp_path / "ref", 5, want)
    with np.load(tmp_path / "port" / "ckpt_00000005.npz") as p, \
            np.load(tmp_path / "ref" / "ckpt_00000005.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(p[key], r[key], err_msg=key)
    tmpl = jax.tree.map(jnp.zeros_like, want)
    got, step = JCK.restore_checkpoint(tmp_path / "port", tmpl)
    assert step == 5
    _ref_equal(jax.tree.map(np.asarray, got), want)


# recurrentgemma smoke at 5 layers: one (rglru, rglru, local) group, and
# two rest layers (rglru, rglru), as the full model's 8 groups and 2 rest
LM_LAYERS = {"recurrentgemma-2b": 5}


def _lm_cfg(get, arch, dtype):
    cfg = dataclasses.replace(get(arch, smoke=True), dtype=dtype)
    return dataclasses.replace(cfg, n_layers=LM_LAYERS.get(arch,
                                                           cfg.n_layers))


def _ref_lm_tree(arch, dtype, seed):
    cfg = _lm_cfg(j_get_config, arch, dtype)
    params = j_api.init_model(jax.random.key(seed), cfg)
    opt = _fill(j_adam(1e-3).init(params), seed)
    opt["t"] = np.int32(5)
    return {"params": jax.tree.map(np.asarray, params), "opt": opt}


@pytest.mark.parametrize("arch,dtype", [("smollm-360m", "float32"),
                                        ("smollm-360m", "bfloat16"),
                                        ("phi3.5-moe-42b-a6.6b", "float32"),
                                        ("falcon-mamba-7b", "float32"),
                                        ("recurrentgemma-2b", "float32"),
                                        ("recurrentgemma-2b", "bfloat16")])
def test_lm_checkpoint_both_ways(arch, dtype, tmp_path):
    want = _ref_lm_tree(arch, dtype, seed=4)
    cfg = _lm_cfg(get_config, arch, dtype)
    # the reference's save, restored by the port into a fresh model
    JCK.save_checkpoint(tmp_path / "ref", 2, want)
    model = backbone.init_params(cfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    params = list(model.parameters())
    paths = backbone.ref_paths(model, cfg)
    state = lm_train_step(cfg, model, adam(1e-3)).state
    restored, step = TCK.restore_checkpoint(
        tmp_path / "ref", TCK.train_tree(params, paths, state))
    TCK.load_train_tree(restored, params, paths, state)
    assert step == 2
    got = {"params": backbone.params_to_jax(model, cfg),
           "opt": to_numpy(opt_to_ref(state["opt"], paths))}
    _ref_equal(got, jax.tree.map(lambda a: np.asarray(a, np.float32)
                                 if np.asarray(a).dtype.kind == "V"
                                 or str(np.asarray(a).dtype) == "bfloat16"
                                 else np.asarray(a), want))
    if dtype == "bfloat16":
        assert model.embed.dtype == torch.bfloat16
    # the port's save of the same values, restored by the reference
    TCK.save_checkpoint(tmp_path / "port", 2,
                        TCK.train_tree(params, paths, state))
    with np.load(tmp_path / "port" / "ckpt_00000002.npz") as p, \
            np.load(tmp_path / "ref" / "ckpt_00000002.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(p[key], r[key], err_msg=key)
    back, _ = JCK.restore_checkpoint(tmp_path / "port", want)
    _ref_equal(jax.tree.map(np.asarray, back), want)


# --------------------------------------------------------------------------
# multi-PS and the dense engine (A2, A4)
# --------------------------------------------------------------------------
def _ps_or_dense_trees(kind, seed):
    """The reference's wdl-tiny tree for a 2-PS run (PS-stacked tables,
    rowwise Adagrad per (shard, row), the sparse state on the linear
    space) or a dense-engine run (``esd_init``), filled; and the port's
    driver template of the same run."""
    from repro.core.dispatch_tpu import esd_init as j_dense_init
    from repro.ps import make_partition as j_partition
    from repro_torch.core.dispatch import esd_init
    from repro_torch.ps import make_partition

    arch = "wdl-tiny"
    cfg = J_DLRM[arch]
    wl = J_WORKLOADS[cfg.workload]
    V = wl.vocab
    params = j_dlrm.init_params(jax.random.key(seed), cfg, wl)
    model = dlrm.init_params(DLRM_CONFIGS[arch], WORKLOADS[cfg.workload],
                             torch.Generator().manual_seed(seed), "cpu")
    if kind == "ps":
        jpart, part = j_partition(V, 2), make_partition(V, 2)
        params = j_dlrm.ps_stack_tables(params, jpart)
        model = dlrm.ps_stack_tables(model, part)
        jesd = j_esd_init(N, jpart.linear_size, int(0.2 * V),
                          max_ids=16 * wl.width)
        esd = esd_sparse_init(N, part.linear_size, int(0.2 * V),
                              max_ids=16 * wl.width)
    else:
        jesd, esd = j_dense_init(N, V), esd_init(N, V)
    tree = {"params": params, "opt": j_adagrad(1e-2).init(params),
            "esd": jesd,
            "qres": {k: jnp.zeros_like(params[k]) for k in ("embed", "wide")}}
    tree = _fill(tree, seed)
    tree["params"] = jax.tree.map(np.asarray, params)
    step = make_train_step(model, bce_loss, rowwise_adagrad(1e-2), "int8")
    return tree, model, dlrm.ref_paths(model), step.state, esd


@pytest.mark.parametrize("kind", ["ps", "dense"])
def test_ps_and_dense_checkpoints_both_ways(kind, tmp_path):
    """A PS-stacked run's checkpoint ((2, max_rows, E) tables, (2,
    max_rows) accumulators, the linear-space state) and a dense-engine
    run's (``esd::{latest, dirty, last_access, step}``): the reference's
    restored by the port's driver tree, the port's save restored by the
    reference, every entry equal."""
    want, model, paths, state, esd = _ps_or_dense_trees(kind, seed=5)
    assert want["params"]["embed"].ndim == (3 if kind == "ps" else 2)
    JCK.save_checkpoint(tmp_path / "ref", 3, want)
    params = list(model.parameters())
    restored, step = TCK.restore_checkpoint(
        tmp_path / "ref", TCK.train_tree(params, paths, state, esd))
    assert step == 3
    esd = TCK.load_train_tree(restored, params, paths, state)
    assert type(esd).__name__ == type(want["esd"]).__name__
    got = {"params": dlrm.params_to_jax(model),
           "opt": to_numpy(opt_to_ref(state["opt"], paths)),
           "esd": type(want["esd"])(*(getattr(esd, f.name).numpy()
                                      for f in dataclasses.fields(esd))),
           "qres": to_numpy(state["qres"])}
    _ref_equal(got, want)
    TCK.save_checkpoint(tmp_path / "port", 3,
                        TCK.train_tree(params, paths, state, esd))
    with np.load(tmp_path / "port" / "ckpt_00000003.npz") as p, \
            np.load(tmp_path / "ref" / "ckpt_00000003.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(p[key], r[key], err_msg=key)
    back, _ = JCK.restore_checkpoint(tmp_path / "port",
                                     jax.tree.map(jnp.zeros_like, want))
    _ref_equal(jax.tree.map(np.asarray, back), want)


@pytest.mark.parametrize("flags", [
    ["--n-ps", "2", "--ps-hetero"],
    ["--n-ps", "3", "--ps-layout", "hashed", "--pipeline-depth", "2"],
    ["--esd-engine", "dense"],
    ["--esd-engine", "dense", "--pipeline-depth", "2"]])
def test_ps_and_dense_runs_resume_exactly(flags, tmp_path):
    """``run_dlrm`` at wdl-tiny, 4 steps with a checkpoint at step 2,
    resumed from it (the step-4 checkpoint removed): the records from
    step 2 on equal the uninterrupted run's exactly.  One CPU thread, as
    tests/test_torch_elastic_resume.py runs (a threaded reduction moves
    a loss's last bits between runs)."""
    from repro_torch.launch.train import main

    keys = ("loss", "miss_pull", "update_push", "evict_push", "cost",
            "alg1_est")
    argv = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker",
            "8", "--steps", "4", "--esd-alpha", "1", "--exchange", "ragged",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2"] + flags
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = main(argv)["metrics"]
        (tmp_path / "ckpt_00000004.npz").unlink()
        resumed = main(argv + ["--resume"])["metrics"]
    finally:
        torch.set_num_threads(threads)
    assert [r["step"] for r in resumed] == [2, 3]
    assert ([[r[k] for k in keys] for r in resumed]
            == [[r[k] for k in keys] for r in full[2:]])
    with np.load(tmp_path / "ckpt_00000002.npz") as ck:
        if "--n-ps" in flags:
            n_ps = int(flags[flags.index("--n-ps") + 1])
            assert ck["params::embed"].shape[0] == n_ps
            assert ck["opt::embed"].shape[0] == n_ps
        else:
            assert "esd::slots" not in ck.files
            assert ck["esd::latest"].shape == (4, 4400)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_ssm_lm_runs_resume_exactly(arch, tmp_path):
    """``run_lm`` of the SSM and hybrid smoke configs, 3 steps with a
    checkpoint after each, resumed from step 2's (step 3's removed): the
    last loss equals the uninterrupted run's exactly; the archive holds
    the reference's leaf names.  One CPU thread, as above."""
    from repro_torch.launch.train import main

    argv = ["--arch", arch, "--smoke", "--seq-len", "32",
            "--batch-per-worker", "2", "--steps", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = main(argv)["metrics"]
        (tmp_path / "ckpt_00000003.npz").unlink()
        resumed = main(argv + ["--resume"])["metrics"]
    finally:
        torch.set_num_threads(threads)
    assert [r["step"] for r in resumed] == [2]
    assert resumed[0]["loss"] == full[2]["loss"]
    leaf = ("params::groups::l0::mamba::A_log" if arch == "falcon-mamba-7b"
            else "params::groups::l1::rec::Lambda")
    with np.load(tmp_path / "ckpt_00000002.npz") as ck:
        assert leaf in ck.files and "opt::t" in ck.files
