"""The multi-PS and dense-engine training slice as a whole: repro_torch
against the JAX package.

The reference side is its stages (``make_dlrm_esd_stages(mesh, ...,
part=, sparse_esd=, use_pallas=True)``) on four host devices, the cache
state moved off the mesh through numpy between steps (ROADMAP C-ref-1
and C-ref-3: its driver and its on-mesh state fail on this tree; its
multi-PS decide warns and prices through ``cost_matrix_sparse_ps_jnp``),
the PS-stacked tables of ``dlrm.ps_stack_tables`` and the unsharded
``bce_loss`` with ``rowwise_adagrad``, in a subprocess that writes an
npz: wdl-tiny, 4 workers of 8, 5 steps, alpha 1, the ragged exchange,
in five configurations: 3 PS contiguous, 3 PS hashed, 3 PS hashed with
the heterogeneous links of ``--ps-hetero`` (the linear space has a
padding row: V = 4,400 over 3 shards is 4,401 wide), the dense engine,
and 2 PS under a plan with a PS outage and a straggler (the elastic
stages, the PAD-masked loss).

The port's multi-PS Alg. 1 runs on B1, whose sum over a sample's ids
runs in order; the reference's ``cost_matrix_sparse_ps_jnp`` sums them
in XLA's order, which differs in the last bit (within 1e-6,
tests/test_torch_ps.py).  On step 0's cold cache with equal links many
costs tie, and a last bit decides the auction's ties (5 of 32
assignments differ).  So the reference's stages here price the
multi-PS Alg. 1 with its own per-slot rows (``per_id_cost_rows_ps``)
pooled in order by its Pallas ``pooled_lookup`` (interpret mode), as
its single-PS decide pools, and everything after the costs is the
reference's.

The port replays the same seeded stream from the same weights through
its stages, and through ``run_dlrm`` at depth 1 and 2.  Assignments,
exchanged arrays, cache counts and the per-(worker, PS) counts are
integers or copies: exact.  The loss is an f32 mean over gradients in
another order: rtol 1e-5; the Alg.-1 estimate and a record's cost:
rtol 1e-5.  The dense engine's records equal the sparse engine's
(``run_dlrm`` at its defaults) exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.dispatch import esd_init, esd_sparse_init
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS, hetero_ps_bandwidths
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.elastic import FaultPlan, cost_column_bias, effective_t
from repro_torch.launch.steps import make_dlrm_esd_stages
from repro_torch.launch.train import build_parser, make_train_step, run_dlrm
from repro_torch.models.dlrm import (bce_loss, bce_loss_masked,
                                     params_from_jax, ps_stack_tables)
from repro_torch.optim import rowwise_adagrad
from repro_torch.ps import make_partition

REPO = Path(__file__).resolve().parents[1]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
OUTAGE = "ps_outage@1:1-4; straggle@2:0x2-3"
# name -> (n_ps, layout, hetero, dense engine, fault plan)
CONFIGS = {"contiguous": (3, "contiguous", False, False, None),
           "hashed": (3, "hashed", False, False, None),
           "hetero": (3, "hashed", True, False, None),
           "dense": (1, "contiguous", False, True, None),
           "outage": (2, "contiguous", False, False, OUTAGE)}
COUNTS = ("miss_pull", "update_push", "evict_push")

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import DLRM_CONFIGS
from repro.core.dispatch_tpu import esd_init, esd_sparse_init
from repro.core.simulator import DEFAULT_BANDWIDTHS, hetero_ps_bandwidths
from repro.data.synthetic import WORKLOADS
from repro.elastic import FaultPlan, cost_column_bias, effective_t
from repro.launch.steps import make_dlrm_esd_stages
from repro.models import dlrm
from repro.optim.optimizers import rowwise_adagrad
from repro.ps import make_partition
from repro.core import dispatch_tpu
from repro.core.cost import dedup_mask_jnp, per_id_cost_rows_ps
from repro.kernels.emb_lookup import pooled_lookup


def ps_cost_in_order(samples, latest, dirty, t_ps, part, linear=False):
    # cost_matrix_sparse_ps_jnp's per-slot rows (per_id_cost_rows_ps at
    # each slot's shard), pooled over the slots in order by the Pallas
    # pooled lookup (interpret mode), as the single-PS decide pools
    k, F = samples.shape
    n = latest.shape[0]
    ids, valid = dedup_mask_jnp(samples)
    shard = part.shard_of_linear(ids) if linear else part.shard_of(ids)
    t_cols = t_ps.astype(jnp.float32)[:, shard.reshape(-1)]
    rows = per_id_cost_rows_ps(latest[:, ids].reshape(n, k * F),
                               dirty[:, ids].reshape(n, k * F), t_cols)
    slot = jnp.arange(k * F, dtype=jnp.int32).reshape(k, F)
    return pooled_lookup(rows, slot, valid.astype(jnp.float32),
                         interpret=True)


dispatch_tpu.cost_matrix_sparse_ps_jnp = ps_cost_in_order
warnings.simplefilter("ignore", RuntimeWarning)   # the ps jnp fallback
out_dir = sys.argv[1]
CONFIGS = eval(sys.argv[2])
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
cfg = DLRM_CONFIGS[ARCH]
wl = WORKLOADS[cfg.workload]
V = wl.vocab
capacity = int(0.2 * V)
mesh = jax.make_mesh((N, 1), ("data", "model"))
params0 = dlrm.init_params(jax.random.key(SEED), cfg, wl)
for name, (n_ps, layout, hetero, dense, spec) in CONFIGS.items():
    part = make_partition(V, n_ps, layout) if n_ps > 1 else None
    V_space = part.linear_size if part is not None else V
    if part is not None:
        bw = (hetero_ps_bandwidths(N, n_ps) if hetero
              else np.repeat(DEFAULT_BANDWIDTHS(N)[:, None], n_ps, axis=1))
    else:
        bw = DEFAULT_BANDWIDTHS(N)
    t_tran = jnp.asarray((cfg.embedding_dim * 4.0) / bw, jnp.float32)
    t_np = np.asarray(t_tran)
    plan = FaultPlan.parse(spec, N, n_ps) if spec else None
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        mesh, N, M, V_space, t_tran, 1.0, part=part, exchange="ragged",
        sparse_esd=not dense, capacity=capacity, use_pallas=True,
        elastic=plan is not None,
        max_failures=plan.max_inactive() if plan is not None else 0)
    state = (esd_init(N, V) if dense else
             esd_sparse_init(N, V_space, capacity,
                             max_ids=out_rows * wl.width))
    params = (dlrm.ps_stack_tables(params0, part) if part is not None
              else params0)
    opt = rowwise_adagrad(LR)
    opt_state = opt.init(params)
    loss_fn = dlrm.bce_loss_masked if plan is not None else dlrm.bce_loss
    grad_fn = jax.jit(jax.value_and_grad(loss_fn), static_argnums=1)
    stream = wl.stream(SEED + 1, N * M)
    rec = {"t": t_np}
    for i in range(STEPS):
        s, d, l = map(jnp.asarray, next(stream))
        if plan is None:
            assign, alg1 = decide(state, s)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        else:
            # the reference driver's fault_arrays(i)
            cs = plan.state_at(i)
            t_eff = effective_t(t_np, cs)
            bias = cost_column_bias(t_eff, wl.width, cs.active,
                                    cs.compute_factor, 0.010)
            act = jnp.asarray(cs.active)
            assign, alg1 = decide(state, s, jnp.asarray(t_eff, jnp.float32),
                                  jnp.asarray(bias, jnp.float32), act)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign,
                                                  act)
        # off the mesh's Explicit axes between steps (ROADMAP C-ref-3)
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), state)
        x = [jnp.asarray(np.asarray(a)) for a in (s2, d2, l2)]
        loss, grads = grad_fn(params, cfg, *x)
        params, opt_state = opt.update(grads, opt_state, params)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss), ("alg1", alg1)] \
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
    out = tmp_path_factory.mktemp("ps_slice")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", str(out)),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                           repr(CONFIGS)],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=str(REPO))
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-4000:]
    p = np.load(out / "params.npz")
    params = {"embed": p["embed"], "wide": p["wide"],
              "bottom": [{"w": p[f"bottom_{i}"]} for i in range(
                  sum(key.startswith("bottom_") for key in p.files))],
              "top": [{"w": p[f"top_{i}"]} for i in range(
                  sum(key.startswith("top_") for key in p.files))]}
    return params, {name: dict(np.load(out / f"ref_{name}.npz"))
                    for name in CONFIGS}


def _stages_replay(params, name):
    n_ps, layout, hetero, dense, spec = CONFIGS[name]
    cfg = DLRM_CONFIGS[ARCH]
    wl = WORKLOADS[cfg.workload]
    V = wl.vocab
    capacity = int(0.2 * V)
    part = make_partition(V, n_ps, layout) if n_ps > 1 else None
    if part is not None:
        bw = (hetero_ps_bandwidths(N, n_ps) if hetero
              else np.repeat(DEFAULT_BANDWIDTHS(N)[:, None], n_ps, axis=1))
    else:
        bw = DEFAULT_BANDWIDTHS(N)
    t_np = ((cfg.embedding_dim * 4.0) / bw).astype(np.float32)
    plan = FaultPlan.parse(spec, N, n_ps) if spec else None
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        N, M, torch.from_numpy(t_np), 1.0, part=part, exchange="ragged",
        sparse_esd=not dense, capacity=capacity, elastic=plan is not None,
        max_failures=plan.max_inactive() if plan is not None else 0)
    state = (esd_init(N, V) if dense else esd_sparse_init(
        N, part.linear_size if part else V, capacity,
        max_ids=out_rows * wl.width))
    model = params_from_jax(params, cfg)
    if part is not None:
        model = ps_stack_tables(model, part)
    train = make_train_step(model, bce_loss_masked if plan else bce_loss,
                            rowwise_adagrad(LR))
    stream = wl.stream(SEED + 1, N * M)
    rec = {}
    for i in range(STEPS):
        s, d, l = next(stream)
        s = torch.as_tensor(s.astype(np.int32))
        d, l = torch.as_tensor(d), torch.as_tensor(l)
        if plan is None:
            assign, alg1 = decide(state, s)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        else:
            cs = plan.state_at(i)
            t_eff = effective_t(t_np, cs).astype(np.float32)
            bias = cost_column_bias(t_eff, wl.width, cs.active,
                                    cs.compute_factor, 0.010)
            act = torch.as_tensor(cs.active)
            assign, alg1 = decide(state, s, torch.from_numpy(t_eff),
                                  torch.from_numpy(bias.astype(np.float32)),
                                  act)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign,
                                                  act)
        loss = train(s2, d2, l2)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss), ("alg1", alg1)] \
                + list(counts.items()):
            rec[f"{key}_{i}"] = v.numpy()
    return rec


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stages_match_reference(reference, name):
    params, refs = reference
    want = refs[name]
    got = _stages_replay(params, name)
    n_ps = CONFIGS[name][0]
    keys = ("assign", "s2", "d2", "l2", "exchange_overflow") + COUNTS
    if n_ps > 1:
        keys += tuple(c + "_ps" for c in COUNTS)
    assert set(got) == set(want) - {"t"}
    for i in range(STEPS):
        for key in keys:
            np.testing.assert_array_equal(got[f"{key}_{i}"],
                                          want[f"{key}_{i}"],
                                          err_msg=f"{key} at step {i}")
        for key in ("loss", "alg1"):
            np.testing.assert_allclose(got[f"{key}_{i}"], want[f"{key}_{i}"],
                                       rtol=1e-5)
    if n_ps > 1:
        # the ids crossed the wire PS-linearized, and the shards' counts
        # split each worker's
        assert want[f"s2_{STEPS - 1}"].max() >= 4400 // n_ps
        for i in range(STEPS):
            for c in COUNTS:
                np.testing.assert_array_equal(
                    want[f"{c}_ps_{i}"].sum(axis=1), want[f"{c}_{i}"])
            assert (want[f"miss_pull_ps_{i}"].sum(axis=0) > 0).all()


def _driver(extra, model):
    return run_dlrm(build_parser().parse_args(
        ["--arch", ARCH, "--workers", str(N), "--batch-per-worker", str(M),
         "--steps", str(STEPS), "--esd-alpha", "1", "--exchange", "ragged",
         "--lr", str(LR), "--device", "cpu", "--seed", str(SEED)] + extra),
        model=model)


def _flags(name):
    n_ps, layout, hetero, dense, spec = CONFIGS[name]
    flags = []
    if n_ps > 1:
        flags += ["--n-ps", str(n_ps), "--ps-layout", layout]
    if hetero:
        flags.append("--ps-hetero")
    if dense:
        flags += ["--esd-engine", "dense"]
    if spec:
        flags += ["--fault-plan", spec]
    return flags


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_driver_matches_reference(reference, name, depth):
    params, refs = reference
    want = refs[name]
    out = _driver(_flags(name) + ["--pipeline-depth", depth],
                  params_from_jax(params, DLRM_CONFIGS[ARCH]))
    assert out["steps"] == STEPS and out["device"] == "cpu"
    n_ps = CONFIGS[name][0]
    for i, rec in enumerate(out["metrics"]):
        for key in COUNTS:
            assert rec[key] == int(want[f"{key}_{i}"].sum()), (key, i)
        suffix = "_ps" if n_ps > 1 else ""
        cost = float(sum((want[f"{op}{suffix}_{i}"] * want["t"]).sum()
                         for op in COUNTS))
        np.testing.assert_allclose(rec["cost"], cost, rtol=1e-5)
        np.testing.assert_allclose(rec["loss"], want[f"loss_{i}"], rtol=1e-5)
        np.testing.assert_allclose(rec["alg1_est"], want[f"alg1_{i}"],
                                   rtol=1e-5)
    if name == "dense":
        sparse = _driver(["--pipeline-depth", depth],
                         params_from_jax(params, DLRM_CONFIGS[ARCH]))
        keys = ("loss", "cost", "alg1_est") + COUNTS
        assert ([[r[k] for k in keys] for r in out["metrics"]]
                == [[r[k] for k in keys] for r in sparse["metrics"]])
        assert type(out["esd_state"]).__name__ == "EsdState"


def test_outage_reprices_the_shard(reference):
    """A PS outage multiplies the shard's link times by 1/0.05 while it
    lasts, and the Alg.-1 estimate rises with it; the records' cost
    stays at the nominal links, as the reference driver's."""
    _, refs = reference
    want = refs["outage"]
    alg1 = [float(want[f"alg1_{i}"]) for i in range(STEPS)]
    assert max(alg1[1:4]) > 5 * alg1[0]
