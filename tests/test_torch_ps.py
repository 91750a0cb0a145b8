"""Multi-PS on the device: repro_torch against the JAX package's
``repro.ps`` layer on the CPU (the mirror of tests/test_ps.py's
``TestPsCost``, ``TestPsStateUpdate``, ``TestNeedIdsLocal``,
``TestPsModelAndSharding`` and ``TestPerPsCapacity``).

* Alg. 1 with per-shard links: the port's B1 route
  (``cost_matrix_sparse_ps_kernel``, B1's plain version here) and its
  plain ``cost_matrix_sparse_ps`` against the reference's
  ``cost_matrix_sparse_ps_jnp`` under ``jax.jit``: rtol 1e-6 (B1 sums a
  sample's ids in order, XLA in its own order: the last bit differs);
  at n_ps = 1, and with column-constant link times, the single-PS route
  bit for bit.  The decide's assignments on those costs: equal.
* ``esd_state_update_sparse(part=)``, per-PS capacities and
  ``need_ids_local``: integers and booleans, exact, against the
  reference under ``jax.jit``, both layouts, n_ps 1, 2 and 3 (3 shards
  of 50 or 40 ids leave padding in the linear space), and the
  reference's ``ValueError`` messages.
* The PS-stacked DLRM: the forward within 1e-6 of the reference's (and
  bit for bit the port's flat forward), row-wise Adagrad's accumulators
  per (shard, row) within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as JC
from repro.core import dispatch_tpu as JD
from repro.core.simulator import hetero_ps_bandwidths as j_hetero
from repro.configs import DLRM_CONFIGS as J_DLRM
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.models import dlrm as j_dlrm
from repro.optim import get_optimizer as j_optimizer
from repro.ps import make_partition as j_partition
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core import cost as TC
from repro_torch.core import dispatch as TD
from repro_torch.core.simulator import DEFAULT_BANDWIDTHS, hetero_ps_bandwidths
from repro_torch.kernels import ops as TO
from repro_torch.models import dlrm as t_dlrm
from repro_torch.optim import get_optimizer as t_optimizer
from repro_torch.ps import make_partition

LAYOUTS = ("contiguous", "hashed")


def _parts(V, n_ps, layout):
    return make_partition(V, n_ps, layout), j_partition(V, n_ps, layout)


def _instance(rng, part, n=4, k=16, F=6):
    """Random PS-linearized planes and samples (in-sample duplicates,
    PAD) over ``part``'s vocabulary."""
    Vs = part.linear_size
    latest = rng.random((n, Vs)) > 0.5
    dirty = (rng.random((n, Vs)) > 0.7) & latest
    samples = rng.integers(0, part.vocab, (k, F))
    samples[:, 1] = samples[:, 0]
    samples[rng.random((k, F)) < 0.15] = -1
    lin = np.asarray(part.to_linear(samples)).astype(np.int32)
    return lin, latest, dirty


def _t_ps(rng, n, n_ps, kind):
    if kind == "hetero":          # the driver's --ps-hetero links
        bw = hetero_ps_bandwidths(n, n_ps)
        np.testing.assert_array_equal(bw, j_hetero(n, n_ps))
        return ((16 * 4.0) / bw).astype(np.float32)
    if kind == "uniform":         # the defaults, repeated per shard
        bw = np.repeat(DEFAULT_BANDWIDTHS(n)[:, None], n_ps, axis=1)
        return ((16 * 4.0) / bw).astype(np.float32)
    return (rng.random((n, n_ps)) * 1e-5 + 1e-6).astype(np.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# --------------------------------------------------------------------------
# Alg. 1 with per-shard links
# --------------------------------------------------------------------------
_ps_jnp = jax.jit(JC.cost_matrix_sparse_ps_jnp, static_argnums=(4, 5))


class TestPsCost:
    @pytest.mark.parametrize("kind", ["random", "hetero", "uniform"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("n_ps", [2, 3])
    def test_kernel_route_matches_reference(self, n_ps, layout, kind):
        rng = np.random.default_rng(n_ps * 10 + len(layout))
        part, jpart = _parts(200, n_ps, layout)
        lin, latest, dirty = _instance(rng, part)
        t_ps = _t_ps(rng, 4, n_ps, kind)
        want = np.asarray(_ps_jnp(*map(jnp.asarray, (lin, latest, dirty,
                                                      t_ps)), jpart, True))
        got = TO.cost_matrix_sparse_ps_kernel(*_t(lin, latest, dirty, t_ps),
                                              part).numpy()
        plain = TC.cost_matrix_sparse_ps(*_t(lin, latest, dirty, t_ps), part,
                                         linear=True).numpy()
        for c in (got, plain):
            assert c.dtype == np.float32
            np.testing.assert_allclose(c, want, rtol=1e-6, atol=0)
        # and both against the numpy simulator's formula
        np_ref = JC.cost_matrix_sparse_ps(lin, latest, dirty, t_ps, jpart,
                                          linear=True)
        np.testing.assert_allclose(got, np_ref, rtol=1e-5)

    def test_nps1_bitwise(self, rng):
        part, jpart = _parts(200, 1, "contiguous")
        lin, latest, dirty = _instance(rng, part)
        t = (rng.random(4) * 1e-5 + 1e-6).astype(np.float32)
        single = TO.cost_matrix_sparse_kernel(*_t(lin, latest, dirty, t))
        ps = TO.cost_matrix_sparse_ps_kernel(*_t(lin, latest, dirty,
                                                 t[:, None]), part)
        assert torch.equal(single, ps)
        a = TC.cost_matrix_sparse(*_t(lin, latest, dirty, t))
        b = TC.cost_matrix_sparse_ps(*_t(lin, latest, dirty, t[:, None]),
                                     part)
        assert torch.equal(a, b)
        # the reference promises its own pair bitwise; the port's jnp twin
        want = np.asarray(_ps_jnp(*map(jnp.asarray, (lin, latest, dirty,
                                                      t[:, None])), jpart,
                                  False))
        np.testing.assert_allclose(b.numpy(), want, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("n_ps", [2, 3])
    def test_column_constant_links_are_the_single_ps_route(self, n_ps,
                                                           layout, rng):
        """Equal links on every shard: per_id_cost_rows_ps does
        per_id_cost_rows' float ops, so the B1 route gives the single-PS
        route's bits."""
        part, _ = _parts(200, n_ps, layout)
        lin, latest, dirty = _instance(rng, part)
        t = (rng.random(4) * 1e-5 + 1e-6).astype(np.float32)
        single = TO.cost_matrix_sparse_kernel(*_t(lin, latest, dirty, t))
        ps = TO.cost_matrix_sparse_ps_kernel(
            *_t(lin, latest, dirty, np.repeat(t[:, None], n_ps, 1)), part)
        assert torch.equal(single, ps)
        cols = torch.as_tensor(np.repeat(t[:, None], 50, 1))
        lat, dr = _t(latest[:, :50], dirty[:, :50])
        assert torch.equal(TC.per_id_cost_rows_ps(lat, dr, cols),
                           TC.per_id_cost_rows(lat, dr, torch.as_tensor(t)))

    def test_per_id_rows_match_reference(self, rng):
        lat = rng.random((4, 64)) < 0.5
        dr = lat & (rng.random((4, 64)) < 0.4)
        cols = (rng.random((4, 64)) * 1e-4).astype(np.float32)
        want = np.asarray(jax.jit(JC.per_id_cost_rows_ps)(
            *map(jnp.asarray, (lat, dr, cols))))
        got = TC.per_id_cost_rows_ps(*_t(lat, dr, cols)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("kind", ["random", "hetero"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_decide_assignments_match_reference(self, layout, kind):
        """The port's multi-PS decide (B1's route, Alg. 2 per worker)
        against the reference's cost and ``hybrid_dispatch_jax``: equal
        assignments on a warm random state."""
        n, m, F = 4, 16, 6
        rng = np.random.default_rng(7 + len(layout))
        part, jpart = _parts(300, 3, layout)
        lin, latest, dirty = _instance(rng, part, n=n, k=n * m, F=F)
        t_ps = _t_ps(rng, n, 3, kind)
        state = TD.SparseEsdState(*_t(latest, dirty), None, None, None)
        got = TD.esd_decide(torch.as_tensor(lin).reshape(n, m, F), state,
                            torch.as_tensor(t_ps), 1.0, part=part).numpy()
        for w in range(n):
            C = _ps_jnp(*map(jnp.asarray, (lin[w * m:(w + 1) * m], latest,
                                           dirty, t_ps)), jpart, True)
            want = np.asarray(JD.hybrid_dispatch_jax(C, m, 1.0))
            np.testing.assert_array_equal(got[w], want, err_msg=f"worker {w}")

    def test_slow_shard_costs_more(self):
        """A miss homed on a slow shard costs more than the same miss on a
        fast one: the signal heterogeneous-PS dispatch uses."""
        part = make_partition(40, 2)     # shard 0: [0, 20), shard 1: [20, 40)
        latest = torch.zeros((2, part.linear_size), dtype=torch.bool)
        dirty = torch.zeros_like(latest)
        t_ps = torch.tensor([[1.0, 10.0], [1.0, 10.0]])
        for ids, cost in (([[5, -1]], 1.0), ([[25, -1]], 10.0)):
            lin = part.to_linear(torch.tensor(ids, dtype=torch.int32))
            C = TO.cost_matrix_sparse_ps_kernel(lin, latest, dirty, t_ps,
                                                part)
            np.testing.assert_allclose(C.numpy(), [[cost, cost]])


# --------------------------------------------------------------------------
# the sparse state machine with per-PS counts and capacities
# --------------------------------------------------------------------------
_j_update = jax.jit(JD.esd_state_update_sparse, static_argnums=(2, 3))


def _need_lists(r, part, n, L):
    ids = np.full((n, L), -1, np.int32)
    for j in range(n):
        g = np.sort(r.choice(part.vocab, r.integers(0, L + 1),
                             replace=False))
        lin = np.sort(np.asarray(part.to_linear(g)))
        ids[j, :len(lin)] = lin
    return ids


def _trace(part, jpart, capacity, iters=15, n=3, L=6, seed=9):
    Vs = part.linear_size
    jcap = tuple(capacity) if isinstance(capacity, list) else capacity
    js = JD.esd_sparse_init(n, Vs, jcap, L)
    ts = TD.esd_sparse_init(n, Vs, capacity, L)
    r = np.random.default_rng(seed)
    evicted = 0
    for it in range(iters):
        ids = _need_lists(r, part, n, L)
        js, jc = _j_update(js, jnp.asarray(ids), jcap, jpart)
        ts, tc = TD.esd_state_update_sparse(ts, torch.as_tensor(ids),
                                            capacity, part)
        assert set(tc) == set(jc)
        for key in jc:
            assert tc[key].dtype == torch.int32, key
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]),
                                          err_msg=f"it{it} {key}")
        for f in ("latest", "dirty", "last_access", "slots", "step"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"it{it} {f}")
        for op in ("miss_pull", "update_push", "evict_push"):
            ps = tc[op + "_ps"]
            assert ps.shape == (n, part.n_ps)
            assert torch.equal(ps.sum(dim=1, dtype=torch.int32), tc[op])
        evicted += int(tc["evict_push"].sum())
    return evicted


class TestPsStateUpdate:
    @pytest.mark.parametrize("capacity", [None, 8])
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("n_ps", [1, 2, 3])
    def test_counts_and_state(self, n_ps, layout, capacity):
        part, jpart = _parts(50, n_ps, layout)
        evicted = _trace(part, jpart, capacity)
        assert (evicted > 0) == (capacity is not None)

    def test_part_leaves_the_transition_alone(self):
        """With and without ``part``: the same state and per-worker
        counts (the breakdown is accounting only)."""
        part = make_partition(50, 3, "hashed")
        a = TD.esd_sparse_init(3, part.linear_size, 8, 6)
        b = TD.esd_sparse_init(3, part.linear_size, 8, 6)
        r = np.random.default_rng(3)
        for _ in range(10):
            ids = torch.as_tensor(_need_lists(r, part, 3, 6))
            a, ca = TD.esd_state_update_sparse(a, ids, 8)
            b, cb = TD.esd_state_update_sparse(b, ids, 8, part)
            for key in ca:
                assert torch.equal(ca[key], cb[key])
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name))

    def test_plane_width_mismatch_raises(self):
        part = make_partition(40, 3)
        state = TD.esd_sparse_init(2, 40)      # 40 != part.linear_size (42)
        with pytest.raises(ValueError, match="part.linear_size"):
            TD.esd_state_update_sparse(
                state, torch.zeros((2, 4), dtype=torch.int32), None, part)


class TestNeedIdsLocal:
    def test_projects_to_owned_rows(self):
        part = make_partition(30, 3)          # 10 rows a shard
        need = torch.tensor([[0, 10, 25, -1], [9, 11, -1, -1]],
                            dtype=torch.int32)
        per_ps = TD.need_ids_local(part.to_linear(need), part)
        assert per_ps.shape == (3, 2, 4) and per_ps.dtype == torch.int32
        assert per_ps[:, 0].tolist() == [[0, -1, -1, -1], [0, -1, -1, -1],
                                         [5, -1, -1, -1]]
        assert per_ps[:, 1].tolist() == [[9, -1, -1, -1], [1, -1, -1, -1],
                                         [-1, -1, -1, -1]]

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("n_ps", [1, 2, 3])
    def test_matches_reference(self, n_ps, layout):
        part, jpart = _parts(50, n_ps, layout)
        r = np.random.default_rng(n_ps)
        ids = _need_lists(r, part, 4, 12)
        want = np.asarray(JD.need_ids_local(jnp.asarray(ids), jpart))
        got = TD.need_ids_local(torch.as_tensor(ids), part)
        np.testing.assert_array_equal(got.numpy(), want)
        # every (shard, local row) maps back to a needed id
        for p in range(n_ps):
            for j in range(4):
                loc = got[p, j][got[p, j] >= 0]
                back = part.local_to_global(torch.full_like(loc, p), loc)
                orig = part.from_linear(torch.as_tensor(ids[j]))
                assert set(back.tolist()) <= set(orig[orig >= 0].tolist())


# --------------------------------------------------------------------------
# the PS-stacked model and its optimizer
# --------------------------------------------------------------------------
class TestPsModelAndSharding:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("arch", ["wdl-tiny", "dfm-tiny", "dcn-tiny"])
    def test_ps_stacked_table_loss_equivalent(self, arch, layout):
        cfg = J_DLRM[arch]
        wl = J_WORKLOADS[cfg.workload]
        part, jpart = _parts(wl.vocab, 3, layout)
        params = j_dlrm.init_params(jax.random.key(0), cfg, wl)
        stacked = j_dlrm.ps_stack_tables(params, jpart)
        model = t_dlrm.params_from_jax(jax.tree.map(np.asarray, params),
                                       DLRM_CONFIGS[arch])
        smodel = t_dlrm.ps_stack_tables(model, part)
        assert smodel.embed.shape == (3, part.max_rows, cfg.embedding_dim)
        for name in ("embed", "wide"):
            if name in stacked:
                np.testing.assert_array_equal(
                    getattr(smodel, name).detach().numpy(),
                    np.asarray(stacked[name]))
        # padding rows zero
        assert part.linear_size > wl.vocab
        pad = np.setdiff1d(np.arange(part.linear_size),
                           np.asarray(part.to_linear(np.arange(wl.vocab))))
        assert not _t_dlrm_flat(smodel.embed)[pad].any()
        rng = np.random.default_rng(2)
        sparse = wl.sample_batch(rng, 8)
        dense = wl.dense_batch(rng, 8)
        labels = wl.label_batch(rng, 8)
        lin = np.asarray(part.to_linear(sparse))
        want = np.asarray(j_dlrm.bce_loss(stacked, cfg, jnp.asarray(lin),
                                          jnp.asarray(dense),
                                          jnp.asarray(labels)))
        got = t_dlrm.bce_loss(smodel, *_t(lin, dense, labels))
        flat = t_dlrm.bce_loss(model, *_t(sparse.astype(np.int64), dense,
                                          labels))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
        assert got.item() == flat.item()

    def test_rowwise_adagrad_ps_stack_accumulators(self):
        """Per-(shard, row) accumulators on a PS-stacked table, against
        the reference's optimizer."""
        rng = np.random.default_rng(4)
        shapes = {"embed": (2, 5, 4), "mlp": (3, 4), "b": (4,)}
        params = {k: rng.normal(size=s).astype(np.float32)
                  for k, s in shapes.items()}
        jopt, topt = (j_optimizer("rowwise_adagrad", 0.1),
                      t_optimizer("rowwise_adagrad", 0.1))
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = [torch.as_tensor(v) for v in params.values()]
        js, ts = jopt.init(jp), topt.init(tp)
        assert [tuple(a.shape) for a in ts] == [(2, 5), (3,), (4,)]
        for _ in range(3):
            grads = {k: rng.normal(size=s).astype(np.float32)
                     for k, s in shapes.items()}
            jp, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 js, jp)
            tp, ts = topt.update([torch.as_tensor(v) for v in grads.values()],
                                 ts, tp)
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(ts[i].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def _t_dlrm_flat(tbl):
    return t_dlrm._flat_table(tbl.detach())


def test_flat_table_passes_flat_tables_through():
    flat = torch.randn(7, 3)
    assert t_dlrm._flat_table(flat) is flat
    stacked = torch.randn(2, 4, 3)
    want = np.asarray(j_dlrm._flat_table(jnp.asarray(stacked.numpy())))
    np.testing.assert_array_equal(t_dlrm._flat_table(stacked).numpy(), want)


# --------------------------------------------------------------------------
# per-PS worker-cache budgets
# --------------------------------------------------------------------------
class TestPerPsCapacity:
    def _ids(self, rng, part, n, L):
        ids = np.full((n, L), -1, np.int32)
        for j in range(n):
            u = np.unique(part.to_linear(rng.integers(0, part.vocab, L)))
            ids[j, :len(u)] = u
        return ids

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("n_ps", [2, 3])
    def test_budgets_match_reference(self, n_ps, layout):
        part, jpart = _parts(50, n_ps, layout)
        caps = [5, 3, 4][:n_ps]
        assert _trace(part, jpart, caps, iters=12, L=8, seed=n_ps) > 0

    def test_seq_len1_bitwise_int(self, rng):
        """capacity=[c] at n_ps = 1 is the plain-int path bit for bit."""
        n, V, L, cap = 3, 64, 8, 10
        part = make_partition(V, 1)
        s_int = TD.esd_sparse_init(n, V, cap, max_ids=L)
        s_seq = TD.esd_sparse_init(n, V, [cap], max_ids=L)
        assert s_seq.slots.shape == s_int.slots.shape
        for _ in range(6):
            ids = torch.as_tensor(self._ids(rng, part, n, L))
            s_int, c_int = TD.esd_state_update_sparse(s_int, ids, cap, part)
            s_seq, c_seq = TD.esd_state_update_sparse(s_seq, ids, [cap],
                                                      part)
            for key in c_int:
                assert torch.equal(c_int[key], c_seq[key]), key
        for f in ("latest", "dirty", "last_access"):
            assert torch.equal(getattr(s_int, f), getattr(s_seq, f))
        assert torch.equal(torch.sort(s_int.slots).values,
                           torch.sort(s_seq.slots).values)

    def test_budgets_respected(self, rng):
        n, V, L = 3, 64, 8
        caps = [6, 3]
        part = make_partition(V, 2)
        s = TD.esd_sparse_init(n, part.linear_size, caps, max_ids=L)
        for _ in range(10):
            ids = torch.as_tensor(self._ids(rng, part, n, L))
            s, c = TD.esd_state_update_sparse(s, ids, caps, part)
        for j in range(n):
            res = torch.nonzero(s.latest[j])[:, 0]
            cnt = torch.bincount(part.shard_of_linear(res), minlength=2)
            pinned = ids[j][ids[j] >= 0].long()
            pin = torch.bincount(part.shard_of_linear(pinned), minlength=2)
            assert (cnt <= torch.tensor(caps) + pin).all(), (cnt, pin)

    def test_errors_match_reference(self, rng):
        n, L = 2, 4
        part, jpart = _parts(32, 2, "contiguous")
        ids = self._ids(rng, part, n, L)
        cases = [((4, 4), None, "part"), ((4, 4, 4), part, "entries")]
        s = TD.esd_sparse_init(n, part.linear_size, [4, 4], max_ids=L)
        js = JD.esd_sparse_init(n, part.linear_size, [4, 4], max_ids=L)
        for caps, p, match in cases:
            with pytest.raises(ValueError, match=match) as got:
                TD.esd_state_update_sparse(s, torch.as_tensor(ids),
                                           list(caps), p)
            with pytest.raises(ValueError) as want:
                JD.esd_state_update_sparse(js, jnp.asarray(ids), list(caps),
                                           jpart if p is not None else None)
            assert str(got.value) == str(want.value)
        small = TD.esd_sparse_init(n, part.linear_size, [2, 2], max_ids=L)
        with pytest.raises(ValueError, match="slot buffer"):
            TD.esd_state_update_sparse(small, torch.as_tensor(ids), [4, 4],
                                       part)
