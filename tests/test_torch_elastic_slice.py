"""The elastic training slice as a whole: repro_torch against the JAX
package.

The reference side is its elastic stages (``make_dlrm_esd_stages(...,
elastic=True, max_failures=plan.max_inactive(), use_pallas=True)``) on
four host devices, its Pallas kernels in interpret mode, with the cache
state moved off the mesh through numpy between steps (ROADMAP C-ref-1
and C-ref-3: the reference's driver and its on-mesh state fail on this
tree), the per-step fault tensors made as its driver's
``fault_arrays(i)`` makes them, and the unsharded PAD-masked loss with
``rowwise_adagrad`` (with ``--codec int8``, the body of its driver's
``train_jit_q``), in a subprocess that writes an npz: wdl-tiny, 4
workers of 8, 6 steps, alpha 1, under a plan with a straggler, a
graceful crash, a bandwidth droop and a warm rejoin.

The port replays the same seeded stream from the same weights through
its elastic stages and through ``run_dlrm --fault-plan``, with and
without ``--codec int8``: assignments, exchanged arrays, cache counts
and ``n_active`` exact, losses within rtol 1e-5.  An empty plan gives
the non-elastic stages' results bit for bit.  The guards are the
reference driver's ``SystemExit`` messages.  (Resume is
tests/test_torch_elastic_resume.py.)
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.cost import transmission_time_codec
from repro_torch.core.dispatch import esd_sparse_init
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.elastic import FaultPlan, cost_column_bias, effective_t
from repro_torch.launch.steps import make_dlrm_esd_stages
from repro_torch.launch.train import (build_parser, main, make_train_step,
                                      run_dlrm)
from repro_torch.models.dlrm import bce_loss_masked, params_from_jax
from repro_torch.optim import rowwise_adagrad
from repro_torch.quant.codecs import resolve_link_codecs

REPO = Path(__file__).resolve().parents[1]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 6, 0, 1e-2
# one step down: the dead worker's penalty column sets the auction's eps
# span, and its rounds run thousands a step on the CPU
PLAN = "straggle@1:0x4-3; crash@2:1g; bw@3:2x0.25-5; rejoin@3:1w"
CODECS = (None, "int8")
COUNTS = ("miss_pull", "update_push", "evict_push")

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import DLRM_CONFIGS
from repro.core.cost import transmission_time_codec
from repro.core.dispatch_tpu import esd_sparse_init
from repro.core.simulator import DEFAULT_BANDWIDTHS
from repro.data.synthetic import WORKLOADS
from repro.elastic import FaultPlan, cost_column_bias, effective_t
from repro.launch.steps import make_dlrm_esd_stages
from repro.models import dlrm
from repro.optim.optimizers import rowwise_adagrad
from repro.quant.codecs import (get_codec, quantize_with_feedback,
                                resolve_link_codecs, ste)

out_dir, spec = sys.argv[1], sys.argv[2]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 6, 0, 1e-2
cfg = DLRM_CONFIGS[ARCH]
wl = WORKLOADS[cfg.workload]
V = wl.vocab
capacity = int(0.2 * V)
mesh = jax.make_mesh((N, 1), ("data", "model"))
plan = FaultPlan.parse(spec, N)
params0 = dlrm.init_params(jax.random.key(SEED), cfg, wl)
bw = DEFAULT_BANDWIDTHS(N)
for name in ("exact", "int8"):
    codec = get_codec(None if name == "exact" else name)
    if codec is None:
        t_tran = jnp.asarray((cfg.embedding_dim * 4.0) / bw, jnp.float32)
    else:
        t_tran = jnp.asarray(transmission_time_codec(
            cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, codec)),
            jnp.float32)
    t_np = np.asarray(t_tran)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        mesh, N, M, V, t_tran, 1.0, exchange="ragged", capacity=capacity,
        use_pallas=True, elastic=True, max_failures=plan.max_inactive(),
        codec=codec)
    state = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    params = params0
    opt = rowwise_adagrad(LR)
    opt_state = opt.init(params)
    qres = {kk: jnp.zeros_like(params[kk]) for kk in ("embed", "wide")}

    @jax.jit
    def step(params, opt_state, qres, s, d, l):
        def loss_q(p):
            qp = dict(p)
            if codec is not None:
                for kk in qres:
                    qp[kk] = ste(p[kk], codec)
            return dlrm.bce_loss_masked(qp, cfg, s, d, l)

        loss, grads = jax.value_and_grad(loss_q)(params)
        grads, new_qres = dict(grads), dict(qres)
        if codec is not None:
            for kk in qres:
                grads[kk], new_qres[kk] = quantize_with_feedback(
                    grads[kk], qres[kk], codec)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, new_qres, loss

    stream = wl.stream(SEED + 1, N * M)
    rec = {"out_rows": np.int64(out_rows)}
    for i in range(STEPS):
        # the reference driver's fault_arrays(i)
        cs = plan.state_at(i)
        t_eff = effective_t(t_np, cs)
        bias = cost_column_bias(t_eff, wl.width, cs.active,
                                cs.compute_factor, 0.010)
        t_arr = jnp.asarray(t_eff, t_tran.dtype)
        b_arr = jnp.asarray(bias, jnp.float32)
        act = jnp.asarray(cs.active)
        s, d, l = map(jnp.asarray, next(stream))
        assign, alg1 = decide(state, s, t_arr, b_arr, act)
        (s2, d2, l2), state, counts = advance(state, s, d, l, assign, act)
        # off the mesh's Explicit axes between steps (ROADMAP C-ref-3)
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), state)
        x = [jnp.asarray(np.asarray(a)) for a in (s2, d2, l2)]
        params, opt_state, qres, loss = step(params, opt_state, qres, *x)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss), ("alg1", alg1),
                       ("n_active", np.int64(cs.n_active))] \
                + list(counts.items()):
            rec[f"{key}_{i}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"), **rec)
p = jax.tree.map(np.asarray, params0)
np.savez(os.path.join(out_dir, "params.npz"), embed=p["embed"],
         wide=p["wide"], **{f"bottom_{i}": lp["w"]
                            for i, lp in enumerate(p["bottom"])},
         **{f"top_{i}": lp["w"] for i, lp in enumerate(p["top"])})
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_slice")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", str(out)),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out), PLAN],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=str(REPO))
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-4000:]
    p = np.load(out / "params.npz")
    params = {"embed": p["embed"], "wide": p["wide"],
              "bottom": [{"w": p[f"bottom_{i}"]} for i in range(
                  sum(key.startswith("bottom_") for key in p.files))],
              "top": [{"w": p[f"top_{i}"]} for i in range(
                  sum(key.startswith("top_") for key in p.files))]}
    refs = {c: dict(np.load(out / f"ref_{c or 'exact'}.npz"))
            for c in CODECS}
    return params, refs


def _t_tran(codec):
    cfg = DLRM_CONFIGS[ARCH]
    bw = DEFAULT_BANDWIDTHS(N)
    return torch.tensor(transmission_time_codec(
        cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, codec)),
        dtype=torch.float32)


def _stages_replay(params, codec, spec=PLAN, elastic=True):
    """The port's stages over the seeded stream; ``elastic=False`` runs
    the non-elastic stages (and ignores ``spec``)."""
    cfg = DLRM_CONFIGS[ARCH]
    wl = WORKLOADS[cfg.workload]
    V = wl.vocab
    capacity = int(0.2 * V)
    t_tran = _t_tran(codec)
    plan = FaultPlan.parse(spec, N)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        N, M, t_tran, 1.0, exchange="ragged", capacity=capacity, codec=codec,
        elastic=elastic, max_failures=plan.max_inactive())
    state = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    train = make_train_step(params_from_jax(params, cfg), bce_loss_masked,
                            rowwise_adagrad(LR), codec)
    stream = wl.stream(SEED + 1, N * M)
    rec = {"out_rows": out_rows}
    for i in range(STEPS):
        cs = plan.state_at(i)
        t_eff = effective_t(t_tran.numpy(), cs)
        bias = cost_column_bias(t_eff, wl.width, cs.active,
                                cs.compute_factor, 0.010)
        arrays = (torch.tensor(t_eff, dtype=torch.float32),
                  torch.tensor(bias, dtype=torch.float32),
                  torch.from_numpy(cs.active))
        s, d, l = next(stream)
        s = torch.as_tensor(s.astype(np.int32))
        d, l = torch.as_tensor(d), torch.as_tensor(l)
        if elastic:
            assign, alg1 = decide(state, s, *arrays)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign,
                                                  arrays[2])
        else:
            assign, alg1 = decide(state, s)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        loss = train(s2, d2, l2)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss), ("alg1", alg1)] \
                + list(counts.items()):
            rec[f"{key}_{i}"] = v.numpy()
        rec[f"n_active_{i}"] = cs.n_active
    return rec, state


@pytest.mark.parametrize("codec", CODECS)
def test_elastic_stages_match_reference(reference, codec):
    params, refs = reference
    want = refs[codec]
    got, _ = _stages_replay(params, codec)
    assert got["out_rows"] == int(want["out_rows"]) == 16   # N * budget
    for i in range(STEPS):
        for key in ("assign", "s2", "d2", "l2", "exchange_overflow",
                    "n_active") + COUNTS:
            np.testing.assert_array_equal(got[f"{key}_{i}"],
                                          want[f"{key}_{i}"],
                                          err_msg=f"{key} at step {i}")
        np.testing.assert_allclose(got[f"loss_{i}"], want[f"loss_{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[f"alg1_{i}"], want[f"alg1_{i}"],
                                   rtol=1e-5)
    plan = FaultPlan.parse(PLAN, N)
    for i in range(STEPS):
        counts = np.bincount(want[f"assign_{i}"], minlength=N)
        for j in np.where(~plan.state_at(i).active)[0]:
            assert counts[j] == 0, (i, j)              # the dead get nothing
            assert (want[f"l2_{i}"].reshape(N, -1)[j] == -1).all()
    assert [int(want[f"n_active_{i}"]) for i in range(STEPS)] == \
        [4, 4, 3, 4, 4, 4]


@pytest.mark.parametrize("codec", CODECS)
def test_elastic_driver_matches_reference(reference, codec):
    params, refs = reference
    want = refs[codec]
    argv = ["--arch", ARCH, "--workers", str(N), "--batch-per-worker",
            str(M), "--steps", str(STEPS), "--esd-alpha", "1", "--exchange",
            "ragged", "--lr", str(LR), "--device", "cpu", "--seed",
            str(SEED), "--fault-plan", PLAN]
    if codec:
        argv += ["--codec", codec]
    out = run_dlrm(build_parser().parse_args(argv),
                   model=params_from_jax(params, DLRM_CONFIGS[ARCH]))
    assert out["steps"] == STEPS
    for i, rec in enumerate(out["metrics"]):
        for key in COUNTS:
            assert rec[key] == int(want[f"{key}_{i}"].sum()), (key, i)
        assert rec["n_active"] == int(want[f"n_active_{i}"])
        np.testing.assert_allclose(rec["loss"], want[f"loss_{i}"], rtol=1e-5)
        np.testing.assert_allclose(rec["alg1_est"], want[f"alg1_{i}"],
                                   rtol=1e-5)


def test_empty_plan_is_the_static_path(reference):
    params, _ = reference
    # one CPU thread: with several, a threaded reduction of the train step
    # sums in an order that varies from run to run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _empty_plan_is_the_static_path(params)
    finally:
        torch.set_num_threads(threads)


def _empty_plan_is_the_static_path(params):
    got, s_got = _stages_replay(params, None, spec="")
    want, s_want = _stages_replay(params, None, spec="", elastic=False)
    assert got["out_rows"] == want["out_rows"] == M
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for f in ("latest", "dirty", "last_access", "slots", "step"):
        assert torch.equal(getattr(s_got, f), getattr(s_want, f)), f


@pytest.mark.parametrize("flags", [
    ["--fault-plan", "crash@1:0"],
    ["--esd-alpha", "1", "--fault-plan", "crash@1:0"],
    ["--esd-alpha", "1", "--exchange", "ragged", "--fault-plan",
     "crash@1:0", "--decide-ahead", "1", "--pipeline-depth", "2"],
    ["--esd-alpha", "1", "--exchange", "ragged", "--fault-plan",
     "crash@1:0", "--prefetch", "4", "--lookahead", "2"],
    ["--esd-alpha", "1", "--resume"]])
def test_guards_are_the_reference_drivers(flags):
    from repro.launch.train import main as ref_main

    argv = ["--arch", ARCH, "--steps", "1"] + flags
    with pytest.raises(SystemExit) as want:
        ref_main(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
