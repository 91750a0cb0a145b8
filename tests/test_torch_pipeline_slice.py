"""The pipelined training slice as a whole: repro_torch against the JAX
package.

The JAX package's training driver fails on this tree (ROADMAP C-ref-1),
so the reference side is its ``PipelinedRunner`` over its stages
(``make_dlrm_esd_stages`` and ``make_dlrm_repair_stage`` with
``use_pallas=True`` on four host devices, the Pallas kernels in
interpret mode), its ``prefetch_step`` (``interpret=True``) and the
unsharded train step, wired as its driver wires them, in a subprocess
that writes an npz.  Every state the stages return is moved off the
mesh through numpy (ROADMAP C-ref-3).  The port runs its driver
``run_dlrm`` from the same initial weights: wdl-tiny, 4 workers of 8,
5 steps, ``--exchange ragged``, alpha 1, in each configuration of
``CONFIGS``.

Integer fields (cache counts, prefetch bytes and hits, reassignments),
``window_dedup_frac``, the final cache state and the final prefetch
plane (ids, expiry and rows, bit for bit) are exact.  Losses and the
Alg.-1 costs are f32 sums taken in another order: rtol 1e-5.  Depth d
and depth 1 of the port give equal records bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.launch.train import build_parser, run_dlrm
from repro_torch.models.dlrm import params_from_jax

REPO = Path(__file__).resolve().parents[1]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
# name: (depth, stale, decide_ahead, lookahead, prefetch, slots, slack, codec)
CONFIGS = {
    "depth2": (2, False, 0, 0, 0, 512, 0.0, None),
    "depth3": (3, False, 0, 0, 0, 512, 0.0, None),
    "stale": (2, True, 0, 0, 0, 512, 0.0, None),
    "ahead_prefetch": (4, False, 3, 4, 16, 64, 0.0, None),
    "ahead_slack": (3, False, 2, 0, 0, 512, 0.5, None),
    "int8_prefetch": (2, False, 0, 2, 16, 64, 0.0, "int8"),
}
INTS = ("miss_pull", "update_push", "evict_push", "prefetch_bytes",
        "demand_miss_bytes", "n_reassigned")

REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from itertools import count
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import DLRM_CONFIGS
from repro.core.cost import transmission_time_codec
from repro.core.dispatch_tpu import esd_sparse_init
from repro.core.simulator import DEFAULT_BANDWIDTHS
from repro.data.synthetic import WORKLOADS
from repro.launch.steps import make_dlrm_esd_stages, make_dlrm_repair_stage
from repro.models import dlrm
from repro.optim.optimizers import rowwise_adagrad
from repro.pipeline import (LookaheadWindow, PipelinedRunner,
                            prefetch_candidates, prefetch_init,
                            prefetch_step, staged_membership)
from repro.quant.codecs import (get_codec, quantize_with_feedback,
                                resolve_link_codecs, row_wire_bytes, ste)

out_dir = sys.argv[1]
CONFIGS = eval(sys.argv[2])
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
cfg = DLRM_CONFIGS[ARCH]
wl = WORKLOADS[cfg.workload]
V = wl.vocab
capacity = int(0.2 * V)
mesh = jax.make_mesh((N, 1), ("data", "model"))
bw = DEFAULT_BANDWIDTHS(N)
params0 = dlrm.init_params(jax.random.key(SEED), cfg, wl)
unshard = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                    tree)


@jax.jit
def with_staged(state, memb):
    return dataclasses.replace(state, latest=state.latest | memb[None, :])


for name, (depth, stale, ahead, look, pf, slots, slack, codec) in \
        CONFIGS.items():
    c = get_codec(codec)
    if c is None:
        t_tran = jnp.asarray((cfg.embedding_dim * 4.0) / bw, jnp.float32)
    else:
        t_tran = jnp.asarray(transmission_time_codec(
            cfg.embedding_dim, bw, resolve_link_codecs("uniform", bw, c)),
            jnp.float32)
    decide, advance, realized, out_rows = make_dlrm_esd_stages(
        mesh, N, M, V, t_tran, 1.0, exchange="ragged", cap_slack=slack,
        capacity=capacity, use_pallas=True, codec=c)
    repair = make_dlrm_repair_stage(mesh, N, M, t_tran, cap_slack=slack,
                                    use_pallas=True)
    esd = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    opt = rowwise_adagrad(LR)
    model = {"params": params0, "opt": opt.init(params0),
             "qres": {k: jnp.zeros_like(params0[k])
                      for k in ("embed", "wide")}}
    loss_fn = dlrm.bce_loss_masked if slack > 0 else dlrm.bce_loss

    @jax.jit
    def step(params, opt_state, qres, s, d, l):
        def loss_q(p):
            qp = dict(p)
            if c is not None:
                for kk in qres:
                    qp[kk] = ste(p[kk], c)
            return loss_fn(qp, cfg, s, d, l)

        loss, grads = jax.value_and_grad(loss_q)(params)
        grads = dict(grads)
        if c is not None:
            new_qres = {}
            for kk in qres:
                grads[kk], new_qres[kk] = quantize_with_feedback(
                    grads[kk], qres[kk], c)
            qres = new_qres
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, qres, loss

    def train_fn(x):
        (model["params"], model["opt"], model["qres"],
         loss) = step(model["params"], model["opt"], model["qres"], *x)
        return loss

    plane = prefetch_init(slots, cfg.embedding_dim) if pf else None
    dec_step, adv_step = count(), count()

    def decide_fn(state, batch):
        i = next(dec_step)
        if pf:
            state = with_staged(state, staged_membership(plane, V, i))
        return decide(state, batch[0][0])

    def advance_fn(state, batch, assign):
        global plane
        (s, d, l), meta = batch
        i = next(adv_step)
        aux = {"meta": meta}
        if pf:
            memb = staged_membership(plane, V, i)
            x, new_state, counts = advance(state, s, d, l, assign, memb)
            new_state = unshard(new_state)
            cids, cexp = prefetch_candidates(meta, i, max(8 * pf, 256))
            plane, n_pulled = prefetch_step(
                plane, model["params"]["embed"], new_state.latest.any(axis=0),
                jnp.asarray(cids), jnp.asarray(cexp), i, budget=pf,
                codec=codec, interpret=True)
            aux["pulled"] = n_pulled
        else:
            x, new_state, counts = advance(state, s, d, l, assign)
            new_state = unshard(new_state)
        aux["counts"] = counts
        return unshard(x), new_state, aux

    realized_fn = ((lambda st, b, a: realized(st, b[0][0], a))
                   if stale or ahead else None)
    repair_fn = None
    if ahead:
        def repair_fn(committed, decided, b, a):
            a2, n_re = repair(committed, decided, b[0][0], a)
            return a2, {"n_reassigned": n_re}

    host = wl.stream(SEED + 1, N * M)
    src = (LookaheadWindow(host, look, key=lambda b: b[0]) if look
           else ((b, None) for b in host))
    batches = ((tuple(map(jnp.asarray, b)), meta) for b, meta in src)
    wire = row_wire_bytes(cfg.embedding_dim, c)
    rec = {}

    def record(t, loss, aux, info):
        counts = {k: np.asarray(v) for k, v in aux["counts"].items()}
        rec[f"loss_{t}"] = np.asarray(loss)
        for k in ("miss_pull", "update_push", "evict_push"):
            rec[f"{k}_{t}"] = counts[k]
        demand = counts.get("demand_miss", counts["miss_pull"]).sum()
        hit = counts["prefetch_hit"].sum() if "prefetch_hit" in counts else 0
        rec[f"demand_miss_bytes_{t}"] = np.asarray(demand * wire)
        rec[f"prefetch_bytes_{t}"] = np.asarray(
            int(np.asarray(aux["pulled"])) * wire if "pulled" in aux else 0)
        rec[f"prefetch_hit_rate_{t}"] = np.asarray(
            round(int(hit) / max(int(hit + demand), 1), 4))
        if aux["meta"] is not None:
            rec[f"window_dedup_frac_{t}"] = np.asarray(
                round(aux["meta"].dedup_frac, 4))
        for k, v in info.items():
            rec[f"{k}_{t}"] = np.asarray(v)
        return t

    runner = PipelinedRunner(decide_fn, advance_fn, train_fn, esd,
                             depth=depth, stale=stale,
                             realized_cost_fn=realized_fn,
                             decide_ahead=ahead, repair_fn=repair_fn)
    runner.run(batches, steps=STEPS, record_fn=record)
    st = runner.esd_state
    rec.update(latest=np.asarray(st.latest), dirty=np.asarray(st.dirty),
               slots=np.asarray(st.slots))
    if pf:
        rec.update(plane_ids=np.asarray(plane.ids),
                   plane_rows=np.asarray(plane.rows),
                   plane_expiry=np.asarray(plane.expiry))
    np.savez(os.path.join(out_dir, f"{name}.npz"), **rec)
p = jax.tree.map(np.asarray, params0)
np.savez(os.path.join(out_dir, "params.npz"), embed=p["embed"],
         wide=p["wide"], **{f"bottom_{i}": lp["w"]
                            for i, lp in enumerate(p["bottom"])},
         **{f"top_{i}": lp["w"] for i, lp in enumerate(p["top"])})
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_slice")
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
    return params, {name: dict(np.load(out / f"{name}.npz"))
                    for name in CONFIGS}


def _argv(depth=1, stale=False, ahead=0, look=0, pf=0, slots=512,
          slack=0.0, codec=None):
    argv = ["--arch", ARCH, "--workers", str(N), "--batch-per-worker",
            str(M), "--steps", str(STEPS), "--esd-alpha", "1", "--exchange",
            "ragged", "--lr", str(LR), "--device", "cpu", "--seed",
            str(SEED), "--pipeline-depth", str(depth), "--decide-ahead",
            str(ahead), "--lookahead", str(look), "--prefetch", str(pf),
            "--prefetch-slots", str(slots), "--cap-slack", str(slack)]
    if stale:
        argv.append("--stale-decide")
    if codec is not None:
        argv += ["--codec", codec]
    return argv


_RUNS = {}


def _port(params, *config):
    """run_dlrm at a configuration (cached: several tests read a run)."""
    if config not in _RUNS:
        _RUNS[config] = run_dlrm(build_parser().parse_args(_argv(*config)),
                                 model=params_from_jax(params,
                                                       DLRM_CONFIGS[ARCH]))
    return _RUNS[config]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_driver_matches_reference(reference, name):
    params, refs = reference
    want = refs[name]
    config = CONFIGS[name]
    out = _port(params, *config)
    stale, ahead, pf = config[1], config[2], config[4]
    assert out["steps"] == STEPS and out["pipeline_depth"] == config[0]
    for i, rec in enumerate(out["metrics"]):
        for key in INTS:
            if f"{key}_{i}" in want:
                assert rec[key] == int(np.asarray(want[f"{key}_{i}"]).sum()), \
                    (key, i)
        assert rec["prefetch_hit_rate"] == float(
            want[f"prefetch_hit_rate_{i}"])
        if config[3]:
            assert rec["window_dedup_frac"] == float(
                want[f"window_dedup_frac_{i}"])
        for key in ("loss", "alg1_est", "alg1_realized"):
            if f"{key}_{i}" in want:
                np.testing.assert_allclose(rec[key], want[f"{key}_{i}"],
                                           rtol=1e-5, err_msg=f"{key} {i}")
        assert ("alg1_realized" in rec) == bool(stale or ahead)
        assert ("n_reassigned" in rec) == bool(ahead)
    st = out["esd_state"]
    for key in ("latest", "dirty", "slots"):
        np.testing.assert_array_equal(getattr(st, key).numpy(), want[key])
    if pf:
        plane = out["prefetch_plane"]
        np.testing.assert_array_equal(plane.ids.numpy(), want["plane_ids"])
        np.testing.assert_array_equal(plane.expiry.numpy(),
                                      want["plane_expiry"])
        np.testing.assert_array_equal(plane.rows.numpy(), want["plane_rows"])
        assert sum(r["prefetch_bytes"] for r in out["metrics"]) > 0
    if ahead:
        assert sum(r["n_reassigned"] for r in out["metrics"][1:]) > 0


@pytest.mark.parametrize("name", ["depth2", "depth3"])
def test_depth_equals_depth_one(reference, name):
    """Exact decisions at any depth are the synchronous run's, bit for
    bit: the schedule changes the issue order only."""
    params, _ = reference
    one = _port(params, 1)["metrics"]
    got = _port(params, *CONFIGS[name])["metrics"]
    keys = ("loss", "cost", "alg1_est") + INTS[:5]
    assert [[r[k] for k in keys] for r in got] == \
        [[r[k] for k in keys] for r in one]


def test_prefetch_splits_misses(reference):
    """The plane splits each step's misses: some leave the demand path,
    and the demand misses never exceed the misses."""
    params, _ = reference
    wire = 4 * DLRM_CONFIGS[ARCH].embedding_dim
    pf = _port(params, *CONFIGS["ahead_prefetch"])["metrics"]
    for r in pf:
        assert r["demand_miss_bytes"] <= r["miss_pull"] * wire
    assert sum(r["demand_miss_bytes"] for r in pf) < \
        sum(r["miss_pull"] * wire for r in pf)
    assert all(r["prefetch_bytes"] > 0 for r in pf)


@pytest.mark.parametrize("extra", [
    ["--stale-decide"],                                     # depth 1
    ["--pipeline-depth", "2", "--decide-ahead", "1", "--stale-decide"],
    ["--prefetch", "8"],                                    # no window
    ["--lookahead", "2", "--prefetch", "64", "--prefetch-slots", "8"],
])
def test_driver_guards(extra):
    base = ["--arch", ARCH, "--steps", "1", "--batch-per-worker", "8",
            "--esd-alpha", "0", "--device", "cpu"]
    with pytest.raises(SystemExit):
        run_dlrm(build_parser().parse_args(base + extra))


@pytest.mark.parametrize("extra", [["--pipeline-depth", "2"],
                                   ["--decide-ahead", "1"],
                                   ["--lookahead", "2", "--prefetch", "8"]])
def test_driver_guards_need_esd(extra):
    base = ["--arch", ARCH, "--steps", "1", "--batch-per-worker", "8",
            "--device", "cpu"]
    with pytest.raises(SystemExit):
        run_dlrm(build_parser().parse_args(base + extra))
