"""The training slice as a whole: repro_torch against the JAX package.

The JAX package's training driver fails on this tree (ROADMAP C-ref-1),
so the reference side is its stages: ``make_dlrm_esd_stages(...,
use_pallas=True)`` on four host devices (its Pallas kernels in
interpret mode, the cache state moved off the mesh between steps as
ROADMAP C-ref-3 requires), the unsharded ``dlrm.bce_loss`` (``bce_loss_masked``
with capacity slack) and ``rowwise_adagrad``, in a subprocess that
writes an npz.  The port replays the same seeded stream from the same
initial weights, once through its own stages and once through its
driver ``run_dlrm``: wdl-tiny, 4 workers, 8 samples each, 5 steps,
``--exchange ragged``, alpha = 1, with and without capacity slack.

The quantized wire (``--codec int8``, its links priced uniformly and by
the bandwidth policy) is held the same way: the reference's stages with
``codec=int8`` (the fused Pallas pack-quantize kernel in interpret
mode) and the body of its driver's ``train_jit_q`` run unsharded under
``jax.jit`` (``ste`` on the tables, ``quantize_with_feedback`` on their
gradients, ``rowwise_adagrad``).

Assignments, exchanged ids and labels, and the cache counts are
integers or copies: exact.  The exchanged dense features are copies,
or with the codec the dequantized wire values, which the port computes
in the reference's jit forms: exact too.  The loss is an f32 mean over
gradients taken in another order: rtol = 1e-5.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core.cost import transmission_time_codec
from repro_torch.core.dispatch import esd_sparse_init
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.launch.steps import make_dlrm_esd_stages
from repro_torch.launch.train import build_parser, make_train_step, run_dlrm
from repro_torch.models.dlrm import bce_loss, bce_loss_masked, params_from_jax
from repro_torch.optim import rowwise_adagrad
from repro_torch.quant.codecs import resolve_link_codecs, row_wire_bytes

REPO = Path(__file__).resolve().parents[1]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
SLACKS = (0.0, 0.5)
POLICIES = ("uniform", "bandwidth")     # with --codec int8
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
from repro.launch.steps import make_dlrm_esd_stages
from repro.models import dlrm
from repro.optim.optimizers import rowwise_adagrad
from repro.quant.codecs import (get_codec, quantize_with_feedback,
                                resolve_link_codecs, ste)

out_dir = sys.argv[1]
ARCH, N, M, STEPS, SEED, LR = "wdl-tiny", 4, 8, 5, 0, 1e-2
cfg = DLRM_CONFIGS[ARCH]
wl = WORKLOADS[cfg.workload]
V = wl.vocab
capacity = int(0.2 * V)
mesh = jax.make_mesh((N, 1), ("data", "model"))
t_tran = jnp.asarray((cfg.embedding_dim * 4.0) / DEFAULT_BANDWIDTHS(N),
                     jnp.float32)
params0 = dlrm.init_params(jax.random.key(SEED), cfg, wl)
for slack in (0.0, 0.5):
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        mesh, N, M, V, t_tran, 1.0, exchange="ragged", cap_slack=slack,
        capacity=capacity, use_pallas=True)
    state = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    params = params0
    opt = rowwise_adagrad(LR)
    opt_state = opt.init(params)
    loss_fn = dlrm.bce_loss_masked if slack > 0 else dlrm.bce_loss
    grad_fn = jax.jit(jax.value_and_grad(loss_fn), static_argnums=1)
    stream = wl.stream(SEED + 1, N * M)
    rec = {}
    for i in range(STEPS):
        s, d, l = map(jnp.asarray, next(stream))
        assign, _ = decide(state, s)
        (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        # the state comes back on the mesh's Explicit axes, which decide's
        # shard_map cannot close over (ROADMAP C-ref-3): unshard it
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), state)
        x = [jnp.asarray(np.asarray(a)) for a in (s2, d2, l2)]
        loss, grads = grad_fn(params, cfg, *x)
        params, opt_state = opt.update(grads, opt_state, params)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss)] + list(counts.items()):
            rec[f"{key}_{i}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, f"ref_{slack}.npz"), **rec)

# the quantized wire: train_jit_q's body, unsharded
codec = get_codec("int8")
bw = DEFAULT_BANDWIDTHS(N)
for policy in ("uniform", "bandwidth"):
    t_q = jnp.asarray(transmission_time_codec(
        cfg.embedding_dim, bw, resolve_link_codecs(policy, bw, codec)),
        jnp.float32)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        mesh, N, M, V, t_q, 1.0, exchange="ragged", capacity=capacity,
        use_pallas=True, codec=codec)
    state = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    params = params0
    opt = rowwise_adagrad(LR)
    opt_state = opt.init(params)
    qres = {kk: jnp.zeros_like(params[kk]) for kk in ("embed", "wide")}

    @jax.jit
    def step_q(params, opt_state, qres, s, d, l):
        def loss_q(p):
            qp = dict(p)
            for kk in qres:
                qp[kk] = ste(p[kk], codec)
            return dlrm.bce_loss(qp, cfg, s, d, l)

        loss, grads = jax.value_and_grad(loss_q)(params)
        grads, new_qres = dict(grads), {}
        for kk in qres:
            grads[kk], new_qres[kk] = quantize_with_feedback(
                grads[kk], qres[kk], codec)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, new_qres, loss

    stream = wl.stream(SEED + 1, N * M)
    rec = {}
    for i in range(STEPS):
        s, d, l = map(jnp.asarray, next(stream))
        assign, _ = decide(state, s)
        (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), state)
        x = [jnp.asarray(np.asarray(a)) for a in (s2, d2, l2)]
        params, opt_state, qres, loss = step_q(params, opt_state, qres, *x)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss)] + list(counts.items()):
            rec[f"{key}_{i}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, f"ref_int8_{policy}.npz"), **rec)
p = jax.tree.map(np.asarray, params0)
np.savez(os.path.join(out_dir, "params.npz"), embed=p["embed"],
         wide=p["wide"], **{f"bottom_{i}": lp["w"]
                            for i, lp in enumerate(p["bottom"])},
         **{f"top_{i}": lp["w"] for i, lp in enumerate(p["top"])})
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_slice")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", str(out)),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=str(REPO))
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-4000:]
    p = np.load(out / "params.npz")
    params = {"embed": p["embed"], "wide": p["wide"],
              "bottom": [{"w": p[f"bottom_{i}"]} for i in range(
                  sum(key.startswith("bottom_") for key in p.files))],
              "top": [{"w": p[f"top_{i}"]} for i in range(
                  sum(key.startswith("top_") for key in p.files))]}
    refs = {s: dict(np.load(out / f"ref_{s}.npz")) for s in SLACKS}
    refs.update({p: dict(np.load(out / f"ref_int8_{p}.npz"))
                 for p in POLICIES})
    return params, refs


def _stages_replay(params, slack, codec=None, policy="uniform"):
    cfg = DLRM_CONFIGS[ARCH]
    wl = WORKLOADS[cfg.workload]
    V = wl.vocab
    capacity = int(0.2 * V)
    bw = DEFAULT_BANDWIDTHS(N)
    if codec is None:
        t_tran = torch.tensor((cfg.embedding_dim * 4.0) / bw,
                              dtype=torch.float32)
    else:
        t_tran = torch.tensor(transmission_time_codec(
            cfg.embedding_dim, bw, resolve_link_codecs(policy, bw, codec)),
            dtype=torch.float32)
    decide, advance, _, out_rows = make_dlrm_esd_stages(
        N, M, t_tran, 1.0, exchange="ragged", cap_slack=slack,
        capacity=capacity, codec=codec)
    state = esd_sparse_init(N, V, capacity, max_ids=out_rows * wl.width)
    train = make_train_step(params_from_jax(params, cfg),
                            bce_loss_masked if slack > 0 else bce_loss,
                            rowwise_adagrad(LR), codec)
    stream = wl.stream(SEED + 1, N * M)
    rec = {}
    for i in range(STEPS):
        s, d, l = next(stream)
        s = torch.as_tensor(s.astype(np.int32))
        d, l = torch.as_tensor(d), torch.as_tensor(l)
        assign, _ = decide(state, s)
        (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
        loss = train(s2, d2, l2)
        for key, v in [("assign", assign), ("s2", s2), ("d2", d2),
                       ("l2", l2), ("loss", loss)] \
                + list(counts.items()):
            rec[f"{key}_{i}"] = v.numpy()
    return rec


@pytest.mark.parametrize("slack", SLACKS)
def test_stages_match_reference(reference, slack):
    params, refs = reference
    want = refs[slack]
    got = _stages_replay(params, slack)
    moved = 0
    for i in range(STEPS):
        for key in ("assign", "s2", "d2", "l2", "exchange_overflow") + COUNTS:
            np.testing.assert_array_equal(got[f"{key}_{i}"],
                                          want[f"{key}_{i}"],
                                          err_msg=f"{key} at step {i}")
        np.testing.assert_allclose(got[f"loss_{i}"], want[f"loss_{i}"],
                                   rtol=1e-5)
        moved += int((want[f"assign_{i}"]
                      != np.repeat(np.arange(N), M // N)[None].repeat(
                          N, 0).reshape(-1)).sum())
    assert moved > 0                      # the dispatch did decide
    assert sum(int(want[f"miss_pull_{i}"].sum()) for i in range(STEPS)) > 0
    if slack:
        assert (want[f"l2_{STEPS - 1}"] == -1).any()   # PAD rows arrived


@pytest.mark.parametrize("slack", SLACKS)
def test_driver_matches_reference(reference, slack):
    params, refs = reference
    want = refs[slack]
    args = build_parser().parse_args(
        ["--arch", ARCH, "--workers", str(N), "--batch-per-worker", str(M),
         "--steps", str(STEPS), "--esd-alpha", "1", "--exchange", "ragged",
         "--cap-slack", str(slack), "--lr", str(LR), "--device", "cpu",
         "--seed", str(SEED)])
    out = run_dlrm(args, model=params_from_jax(params, DLRM_CONFIGS[ARCH]))
    assert out["steps"] == STEPS and out["device"] == "cpu"
    for i, rec in enumerate(out["metrics"]):
        for key in COUNTS:
            assert rec[key] == int(want[f"{key}_{i}"].sum()), (key, i)
        np.testing.assert_allclose(rec["loss"], want[f"loss_{i}"], rtol=1e-5)
        assert rec["prefetch_bytes"] == 0
        assert rec["demand_miss_bytes"] == rec["miss_pull"] * 16 * 4
    for key in ("decide_ms_mean", "advance_ms_mean", "train_ms_mean"):
        assert out[key] > 0


def _driver_args(extra):
    return build_parser().parse_args(
        ["--arch", ARCH, "--workers", str(N), "--batch-per-worker", str(M),
         "--steps", str(STEPS), "--esd-alpha", "1", "--exchange", "ragged",
         "--lr", str(LR), "--device", "cpu", "--seed", str(SEED)] + extra)


@pytest.mark.parametrize("policy", POLICIES)
def test_codec_stages_match_reference(reference, policy):
    params, refs = reference
    want = refs[policy]
    got = _stages_replay(params, 0.0, codec="int8", policy=policy)
    exact = refs[0.0]
    for i in range(STEPS):
        for key in ("assign", "s2", "d2", "l2", "exchange_overflow") + COUNTS:
            np.testing.assert_array_equal(got[f"{key}_{i}"],
                                          want[f"{key}_{i}"],
                                          err_msg=f"{key} at step {i}")
        np.testing.assert_allclose(got[f"loss_{i}"], want[f"loss_{i}"],
                                   rtol=1e-5)
    # the dense features did cross the quantized wire
    assert not np.array_equal(want["d2_0"], exact["d2_0"])


@pytest.mark.parametrize("policy", POLICIES)
def test_codec_driver_matches_reference(reference, policy):
    params, refs = reference
    want = refs[policy]
    out = run_dlrm(_driver_args(["--codec", "int8", "--codec-policy",
                                 policy]),
                   model=params_from_jax(params, DLRM_CONFIGS[ARCH]))
    assert out["steps"] == STEPS and out["codec"] == "int8"
    for i, rec in enumerate(out["metrics"]):
        for key in COUNTS:
            assert rec[key] == int(want[f"{key}_{i}"].sum()), (key, i)
        np.testing.assert_allclose(rec["loss"], want[f"loss_{i}"], rtol=1e-5)
        assert rec["demand_miss_bytes"] == rec["miss_pull"] * row_wire_bytes(
            DLRM_CONFIGS[ARCH].embedding_dim, "int8")


@pytest.mark.parametrize("slack,codec", [(0.0, None), (0.5, None),
                                         (0.0, "int8")])
def test_advance_packs_once_a_step(reference, monkeypatch, slack, codec):
    """The advance moves ids, dense features and labels with one pack a
    step over all workers (on the card one pack_send_all launch; with the
    codec the dense features quantized in that pack, marked as the one
    quantized payload), never through the pack-quantize alone, and its
    outputs and counts stay the reference's."""
    from repro_torch.exchange import ragged
    from repro_torch.kernels import exchange_pack

    calls = {"pack_send_all": 0, "gather_rows_quant": 0}
    marks = []

    def pack(*a, _fn=ragged.pack_send_all, **k):
        calls["pack_send_all"] += 1
        marks.append(tuple(a[6]) if len(a) > 6 else tuple(
            k.get("quantized", ())))
        return _fn(*a, **k)

    def alone(*a, _fn=exchange_pack.gather_rows_quant, **k):
        calls["gather_rows_quant"] += 1
        return _fn(*a, **k)

    monkeypatch.setattr(ragged, "pack_send_all", pack)
    monkeypatch.setattr(exchange_pack, "gather_rows_quant", alone)
    params, refs = reference
    want = refs[slack] if codec is None else refs["uniform"]
    got = _stages_replay(params, slack, codec=codec)
    assert calls == {"pack_send_all": STEPS, "gather_rows_quant": 0}
    assert marks == [(False, codec is not None, False)] * STEPS
    for i in range(STEPS):
        for key in ("assign", "s2", "d2", "l2", "exchange_overflow") + COUNTS:
            np.testing.assert_array_equal(got[f"{key}_{i}"],
                                          want[f"{key}_{i}"],
                                          err_msg=f"{key} at step {i}")

