"""The dense cache engine and the one-call dispatch: repro_torch against
the JAX package on the CPU.

* ``esd_state_update`` (the (n, V) planes, every id every step) against
  the reference's under ``jax.jit``, 15 steps, with no capacity, an LRU
  capacity, capacity 0 and a staged prefetch plane: counts and planes
  exact; the LRU cut's (last_access, id) order at V = 1e6 past the step
  where a packed int32 key would wrap.
* ``need_matrix`` against the reference's (its ``all_gather`` under
  ``jax.vmap``): exact.
* The dense and sparse engines over one trace: the same counts and
  planes (as tests/test_sparse_engine.py holds the reference's pair).
* Alg. 1 over the dense (V, n) table: ``cost_matrix_kernel`` (B1's
  plain version) against ``cost_matrix_pallas`` in interpret mode bit
  for bit, and against the port's compact route bit for bit;
  ``cost_matrix_dense`` against ``cost_matrix_jnp`` under ``jax.jit``
  within rtol 1e-6 (a sum over the slots in another order).
* ``esd_dispatch``, padded and ragged, the compact and the dense cost,
  with capacity slack and with two PS shards, against the reference's
  ``esd_dispatch(use_pallas=True)`` under ``shard_map`` on 4 host
  devices in a subprocess: exchanged samples and assignments exact.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as JC
from repro.core import dispatch_tpu as JD
from repro.kernels.ops import cost_matrix_pallas
from repro_torch.core import cost as TC
from repro_torch.core import dispatch as TD
from repro_torch.kernels import ops as TO
from repro_torch.ps import make_partition

REPO = Path(__file__).resolve().parents[1]
_j_dense = jax.jit(JD.esd_state_update, static_argnums=(2,))


def _need(r, n, V, frac):
    return r.random((n, V)) < frac


@pytest.mark.parametrize("capacity", [None, 6, 12, 0])
@pytest.mark.parametrize("staged", [False, True])
def test_state_update_matches_reference(capacity, staged):
    n, V = 3, 40
    js, ts = JD.esd_init(n, V), TD.esd_init(n, V)
    r = np.random.default_rng(0 if capacity is None else capacity + 1)
    evicted = 0
    for it in range(15):
        need = _need(r, n, V, 0.2)
        memb = r.random(V) < 0.3 if staged else None
        js, jc = _j_dense(js, jnp.asarray(need), capacity,
                          None if memb is None else jnp.asarray(memb))
        ts, tc = TD.esd_state_update(ts, torch.as_tensor(need), capacity,
                                     None if memb is None
                                     else torch.as_tensor(memb))
        assert set(tc) == set(jc)
        for key in jc:
            assert tc[key].dtype == torch.int32
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]),
                                          err_msg=f"it{it} {key}")
        for f in ("latest", "dirty", "last_access", "step"):
            g, w = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f"it{it} {f}")
        evicted += int(tc["evict_push"].sum())
        if capacity == 0:
            assert torch.equal(ts.latest, torch.as_tensor(need))
    assert (evicted > 0) == (capacity is not None)
    if staged:
        assert int(tc["prefetch_hit"].sum()) > 0


def test_lru_cut_order_at_paper_scale():
    """At V = 1e6 and step > 2147 a packed last_access * V + id key
    would wrap int32: the stable sort on last_access still evicts the
    reference's victim (id 10 loses the tie against 20)."""
    V, cap = 1_000_000, 2
    start = 2_999
    js = dataclasses.replace(JD.esd_init(1, V),
                             step=jnp.asarray(start, jnp.int32))
    ts = dataclasses.replace(TD.esd_init(1, V),
                             step=torch.tensor(start, dtype=torch.int32))
    for ids in ([10, 20], [30]):
        need = np.zeros((1, V), bool)
        need[0, ids] = True
        js, jc = _j_dense(js, jnp.asarray(need), cap)
        ts, tc = TD.esd_state_update(ts, torch.as_tensor(need), cap)
        for key in jc:
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert torch.nonzero(ts.latest[0])[:, 0].tolist() == [20, 30]
    np.testing.assert_array_equal(ts.latest.numpy(), np.asarray(js.latest))


def test_need_matrix_matches_reference():
    n, R, F, V = 4, 6, 5, 50
    r = np.random.default_rng(1)
    s = r.integers(-1, V, (n, R, F)).astype(np.int32)
    want = np.asarray(jax.vmap(lambda x: JD.need_matrix(x, "data", V),
                               axis_name="data")(jnp.asarray(s)))[0]
    got = TD.need_matrix(torch.as_tensor(s), V)
    assert got.dtype == torch.bool and got.shape == (n, V)
    np.testing.assert_array_equal(got.numpy(), want)
    for j in range(n):
        ids = set(s[j].reshape(-1).tolist()) - {-1}
        assert set(torch.nonzero(got[j])[:, 0].tolist()) == ids


@pytest.mark.parametrize("capacity", [None, 10, 8, 0])
def test_dense_and_sparse_engines_identical(capacity):
    n, V, L = 3, 50, 8
    d = TD.esd_init(n, V)
    s = TD.esd_sparse_init(n, V, capacity, L)
    r = np.random.default_rng(5)
    for it in range(20):
        need = np.zeros((n, V), bool)
        ids = np.full((n, L), -1, np.int32)
        for j in range(n):
            u = np.sort(r.choice(V, r.integers(0, L + 1), replace=False))
            need[j, u] = True
            ids[j, :len(u)] = u
        d, dc = TD.esd_state_update(d, torch.as_tensor(need), capacity)
        s, sc = TD.esd_state_update_sparse(s, torch.as_tensor(ids), capacity)
        for key in dc:
            assert torch.equal(dc[key], sc[key]), f"it{it} {key}"
        for f in ("latest", "dirty", "last_access", "step"):
            assert torch.equal(getattr(d, f), getattr(s, f)), f"it{it} {f}"
        # need_matrix and need_ids_list name the same ids
        assert torch.equal(TD.need_matrix(torch.as_tensor(ids)[:, None], V),
                           torch.as_tensor(need))


def _instance(rng, n=4, V=200, k=16, F=6):
    latest = rng.random((n, V)) > 0.5
    dirty = (rng.random((n, V)) > 0.7) & latest
    t = (rng.random(n) * 1e-5 + 1e-6).astype(np.float32)
    samples = rng.integers(0, V, (k, F))
    samples[:, 1] = samples[:, 0]
    samples[rng.random((k, F)) < 0.15] = -1
    return samples.astype(np.int32), latest, dirty, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_cost_matches_reference(seed):
    s, latest, dirty, t = _instance(np.random.default_rng(seed))
    args_j = tuple(map(jnp.asarray, (s, latest, dirty, t)))
    args_t = tuple(map(torch.as_tensor, (s, latest, dirty, t)))
    kern = TO.cost_matrix_kernel(*args_t)
    np.testing.assert_array_equal(
        kern.numpy(), np.asarray(cost_matrix_pallas(*args_j, interpret=True)))
    assert torch.equal(kern, TO.cost_matrix_sparse_kernel(*args_t))
    table, ids, w = TO.cost_table_dense(*args_t)
    assert table.shape == (latest.shape[1], 4) and ids.dtype == torch.int32
    plain = TC.cost_matrix_dense(*args_t)
    want = np.asarray(jax.jit(JC.cost_matrix_jnp)(*args_j))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        plain.numpy(), JC.cost_matrix_np(s, latest, dirty, t), rtol=1e-5)


def test_dense_cost_all_pad_and_id_zero_after_pad():
    latest = torch.zeros((2, 10), dtype=torch.bool)
    dirty = torch.zeros_like(latest)
    t = torch.tensor([1.0, 2.0])
    pad = torch.full((3, 4), -1, dtype=torch.int32)
    for fn in (TO.cost_matrix_kernel, TC.cost_matrix_dense):
        assert not fn(pad, latest, dirty, t).any()
        C = fn(torch.tensor([[-1, 0, 5]], dtype=torch.int32), latest, dirty,
               t)
        np.testing.assert_allclose(C.numpy(), [[2.0, 4.0]])  # two misses


# --------------------------------------------------------------------------
# esd_dispatch against the reference's under shard_map
# --------------------------------------------------------------------------
N, M, F, V = 4, 16, 6, 200
# name -> (exchange, sparse_cost, cap_slack, alpha, n_ps)
CASES = {"padded": ("padded", True, 0.0, 1.0, 1),
         "padded dense": ("padded", False, 0.0, 0.5, 1),
         "ragged": ("ragged", True, 0.0, 1.0, 1),
         "ragged dense slack": ("ragged", False, 0.5, 1.0, 1),
         "ragged slack heu": ("ragged", True, 0.5, 0.0, 1),
         "ragged 2 PS": ("ragged", True, 0.0, 1.0, 2)}

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.core.dispatch_tpu import esd_dispatch, esd_init
from repro.core.simulator import hetero_ps_bandwidths
from repro.ps import make_partition

warnings.simplefilter("ignore", RuntimeWarning)   # the ps jnp fallback
out_dir = sys.argv[1]
CASES = eval(sys.argv[2])
N, M, F, V = 4, 16, 6, 200
mesh = jax.make_mesh((N,), ("data",))
rec = {}
for i, (name, (exchange, sparse_cost, slack, alpha, n_ps)) in enumerate(
        CASES.items()):
    rng = np.random.default_rng(i)
    part = make_partition(V, n_ps) if n_ps > 1 else None
    Vs = part.linear_size if part is not None else V
    state = esd_init(N, Vs)
    state.latest = jnp.asarray(rng.random((N, Vs)) > 0.5)
    state.dirty = jnp.asarray((rng.random((N, Vs)) > 0.7)
                              & np.asarray(state.latest))
    if part is not None:
        t = jnp.asarray(64.0 / hetero_ps_bandwidths(N, n_ps), jnp.float32)
    else:
        t = jnp.asarray(rng.random(N) * 1e-5 + 1e-6, jnp.float32)
    s = rng.integers(0, V, (N * M, F))
    s[rng.random((N * M, F)) < 0.15] = -1
    if part is not None:
        s = np.asarray(part.to_linear(s))
    s = s.astype(np.int32)

    def f(x):
        return esd_dispatch(x, state, t, alpha, use_pallas=True,
                            sparse_cost=sparse_cost, part=part,
                            cap_slack=slack, exchange=exchange)

    exch, assign = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("data", None),),
        out_specs=(P("data", None), P("data")),
        check_rep=False))(jnp.asarray(s))
    for key, v in (("samples", s), ("latest", state.latest),
                   ("dirty", state.dirty), ("t", t), ("exch", exch),
                   ("assign", assign)):
        rec[f"{name}/{key}"] = np.asarray(v)
np.savez(os.path.join(out_dir, "dispatch.npz"), **rec)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dispatch")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", str(out)),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                           repr(CASES)], capture_output=True, text=True,
                          timeout=900, env=env, cwd=str(REPO))
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-4000:]
    return dict(np.load(out / "dispatch.npz"))


@pytest.mark.parametrize("name", list(CASES))
def test_esd_dispatch_matches_reference(reference, name):
    exchange, sparse_cost, slack, alpha, n_ps = CASES[name]
    ref = {k.split("/", 1)[1]: v for k, v in reference.items()
           if k.startswith(name + "/")}
    part = make_partition(V, n_ps) if n_ps > 1 else None
    state = TD.esd_init(N, ref["latest"].shape[1])
    state = dataclasses.replace(state, latest=torch.as_tensor(ref["latest"]),
                                dirty=torch.as_tensor(ref["dirty"]))
    exch, assign = TD.esd_dispatch(
        torch.as_tensor(ref["samples"]).reshape(N, M, F), state,
        torch.as_tensor(ref["t"]), alpha, sparse_cost=sparse_cost,
        part=part, cap_slack=slack, exchange=exchange)
    np.testing.assert_array_equal(assign.reshape(-1).numpy(), ref["assign"])
    np.testing.assert_array_equal(exch.reshape(-1, F).numpy(), ref["exch"])
    if slack:
        assert exch.shape[1] > M and (exch == -1).all(dim=2).any()
    # the dispatch did move samples off their source
    home = np.repeat(np.arange(N), M // N)[None].repeat(N, 0).reshape(-1)
    assert (ref["assign"] != home).any()


def test_esd_dispatch_guards():
    state = TD.esd_init(N, V)
    s = torch.zeros((N, M, F), dtype=torch.int32)
    t = torch.ones(N)
    with pytest.raises(ValueError, match="unknown exchange mode"):
        TD.esd_dispatch(s, state, t, 1.0, exchange="bogus")
    with pytest.raises(ValueError, match="cap_slack > 0 needs"):
        TD.esd_dispatch(s, state, t, 1.0, cap_slack=0.5)


# --------------------------------------------------------------------------
# the pipeline over the dense engine
# --------------------------------------------------------------------------
def test_changed_samples_mask_on_dense_states():
    """``changed_samples_mask`` reads either engine's planes: against the
    reference's on two dense states."""
    n, m, F, V = 4, 6, 5, 40
    r = np.random.default_rng(3)
    planes = [(r.random((n, V)) < 0.5, r.random((n, V)) < 0.3)
              for _ in range(2)]
    planes[1][0][:, :20] = planes[0][0][:, :20]     # half the ids unchanged
    planes[1][1][:, :20] = planes[0][1][:, :20]
    s = r.integers(-1, V, (n, m, F)).astype(np.int32)
    s[0] = np.where(s[0] >= 0, s[0] % 20, -1)         # worker 0: unchanged
    js = [JD.esd_init(n, V) for _ in planes]
    ts = [TD.esd_init(n, V) for _ in planes]
    for i, (lat, dr) in enumerate(planes):
        js[i] = dataclasses.replace(js[i], latest=jnp.asarray(lat),
                                    dirty=jnp.asarray(dr))
        ts[i] = dataclasses.replace(ts[i], latest=torch.as_tensor(lat),
                                    dirty=torch.as_tensor(dr))
    got = TD.changed_samples_mask(torch.as_tensor(s), *ts)
    for w in range(n):
        want = np.asarray(JD.changed_samples_mask(jnp.asarray(s[w]), *js))
        np.testing.assert_array_equal(got[w].numpy(), want)
    assert not got[0].any() and got[1:].any()


@pytest.mark.parametrize("flags", [
    ["--pipeline-depth", "2", "--stale-decide"],
    ["--pipeline-depth", "3", "--decide-ahead", "2", "--lookahead", "2",
     "--prefetch", "8", "--prefetch-slots", "32"]])
def test_pipeline_on_the_dense_engine(flags):
    """The runner, the double buffer, the repair and the prefetch split
    over the dense engine's state: every record the sparse engine's."""
    from repro_torch.launch.train import main

    base = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker",
            "8", "--steps", "4", "--esd-alpha", "1", "--exchange", "ragged",
            "--device", "cpu"] + flags
    dense = main(base + ["--esd-engine", "dense"])
    sparse = main(base)
    assert type(dense["esd_state"]) is TD.EsdState
    for a, b in zip(dense["metrics"], sparse["metrics"], strict=True):
        assert set(a) == set(b)
        for key in a:
            if key != "wall_s":
                assert a[key] == b[key], key
    assert all("alg1_realized" in r for r in dense["metrics"])
