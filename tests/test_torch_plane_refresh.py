"""The in-place plane refresh and prefetch pull against the JAX package.

The port's serving refresh (``refresh_plane``, ``seed_plane``) and the
training prefetch round (``prefetch_step``) update the plane they are
given in place: one ``plane_refresh`` (a stable budget select, the due
rows only) and one ``staged_pull`` (a compacted list of slots), where
the reference writes a new plane through ``staged_gather``.  Inputs are
made in numpy from a seed and handed to both packages.  Nothing is
summed: rows are bitwise equal, ids, expiry and counts exactly equal,
and the returned planes share storage with their inputs.  The kernels'
plain versions (what runs on the CPU) are also held against a numpy
stable argsort of the keys, and the select-only list against it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import emb_lookup as jk
from repro.pipeline import prefetch as jpf
from repro.pipeline.window import LookaheadWindow
from repro.serve import plane as jpl
from repro_torch.kernels import emb_lookup as tk
from repro_torch.pipeline import prefetch as tpf
from repro_torch.serve import plane as tpl

FIELDS = ("ids", "rows", "expiry")
INT32_MAX = np.iinfo(np.int32).max


def _jplane(ids, rows, exp):
    return jpf.PrefetchPlane(ids=jnp.asarray(ids, jnp.int32),
                             rows=jnp.asarray(rows, jnp.float32),
                             expiry=jnp.asarray(exp, jnp.int32))


def _tplane(ids, rows, exp):
    return tpf.PrefetchPlane(
        ids=torch.tensor(np.asarray(ids, np.int32)),
        rows=torch.tensor(np.asarray(rows, np.float32)),
        expiry=torch.tensor(np.asarray(exp, np.int32)))


def _assert_same(tp, jp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def _storage(p):
    return [getattr(p, f).data_ptr() for f in FIELDS]


def _random_plane(rng, V, C, E, *, empty=0.1, exp_hi=8):
    ids = rng.choice(V, C, replace=False).astype(np.int32)
    ids[rng.random(C) < empty] = -1
    rows = rng.standard_normal((C, E)).astype(np.float32)
    exp = rng.integers(-1, exp_hi, C).astype(np.int32)
    return ids, rows, exp


def _refresh_both(arrays, table, step, ttl, budget, codec=None, **jkw):
    jp, jn = jpl.refresh_plane(_jplane(*arrays), jnp.asarray(table), step,
                               ttl=ttl, budget=budget, codec=codec, **jkw)
    tp = _tplane(*arrays)
    before = _storage(tp)
    out, tn = tpl.refresh_plane(tp, torch.from_numpy(table), step, ttl=ttl,
                                budget=budget, codec=codec)
    assert out is tp and _storage(out) == before      # in place
    assert tn.dtype == torch.int32 and tn.dim() == 0
    assert int(tn) == int(jn)
    _assert_same(out, jp)
    return int(tn)


def _numpy_kept(ids, exp, step, budget):
    """The kept slots by a numpy stable argsort of the keys, in slot
    order: an implementation of the reference's rule apart from both
    packages'."""
    due = (ids >= 0) & (exp <= step)
    if budget is None:
        return np.flatnonzero(due)
    key = np.where(due, exp, INT32_MAX)
    order = np.argsort(key, kind="stable")
    rank = np.empty(len(ids), np.int64)
    rank[order] = np.arange(len(ids))
    return np.flatnonzero(due & (rank < budget))


# budgets: None, 1, 64, past the due count, at and past C
@pytest.mark.parametrize("budget", [None, 1, 7, 64, 150, 200, 10_000])
@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_matches_jax(budget, seed):
    rng = np.random.default_rng(seed)
    V, C, E = 400, 150, 12
    arrays = _random_plane(rng, V, C, E)
    table = rng.standard_normal((V, E)).astype(np.float32)
    n_due = int(((arrays[0] >= 0) & (arrays[2] <= 4)).sum())
    assert 10 < n_due < 150
    n = _refresh_both(arrays, table, 4, 3, budget)
    assert n == (n_due if budget is None else min(budget, n_due))


@pytest.mark.parametrize("budget", [None, 1, 64, 200])
def test_refresh_cold_plane_ties_match_jax(budget):
    """A cold plane: every slot due with one expiry, so the budget is
    cut by slot order alone."""
    rng = np.random.default_rng(2)
    V, C, E = 500, 200, 8
    ids = rng.choice(V, C, replace=False).astype(np.int32)
    arrays = (ids, rng.standard_normal((C, E)).astype(np.float32),
              np.full(C, 32, np.int32))
    table = rng.standard_normal((V, E)).astype(np.float32)
    n = _refresh_both(arrays, table, 32, 32, budget)
    assert n == (C if budget is None else min(budget, C))


def test_refresh_nothing_due_matches_jax():
    rng = np.random.default_rng(3)
    V, C, E = 100, 40, 4
    ids, rows, _ = _random_plane(rng, V, C, E)
    arrays = (ids, rows, rng.integers(5, 9, C).astype(np.int32))
    table = rng.standard_normal((V, E)).astype(np.float32)
    for budget in (None, 3, 64):
        assert _refresh_both(arrays, table, 4, 2, budget) == 0


def test_refresh_matches_the_pallas_pull():
    """Once against the reference's Pallas staged_gather pull, in
    interpret mode."""
    rng = np.random.default_rng(4)
    V, C, E = 60, 16, 8
    arrays = _random_plane(rng, V, C, E, exp_hi=5)
    table = rng.standard_normal((V, E)).astype(np.float32)
    assert _refresh_both(arrays, table, 3, 2, 4, use_pallas=True,
                         interpret=True) > 0


@pytest.mark.parametrize("codec", [None, "fp16", "int8", "int4"])
@pytest.mark.parametrize("budget", [None, 5])
def test_refresh_rounds_match_jax(codec, budget):
    """Seed, then rounds on a changing table, each on the previous plane
    (the port's the same tensors throughout): cold ties first, then a
    spread of expiries."""
    rng = np.random.default_rng(5)
    V, C, E = 90, 30, 16
    table = rng.standard_normal((V, E)).astype(np.float32)
    ids = rng.choice(V, C, replace=False)
    jp = jpl.seed_plane(jnp.asarray(table), ids, step=0, ttl=2, codec=codec)
    tp = tpl.seed_plane(torch.from_numpy(table), ids, step=0, ttl=2,
                        codec=codec)
    _assert_same(tp, jp)
    storage = _storage(tp)
    total = 0
    for step in range(2, 10):
        table = table * 1.25 + 0.5
        jp, jn = jpl.refresh_plane(jp, jnp.asarray(table), step, ttl=2,
                                   budget=budget, codec=codec)
        tp, tn = tpl.refresh_plane(tp, torch.from_numpy(table), step, ttl=2,
                                   budget=budget, codec=codec)
        assert int(tn) == int(jn), step
        assert _storage(tp) == storage
        _assert_same(tp, jp)
        total += int(tn)
    assert total > 0


@pytest.mark.parametrize("codec", ["fp16", "int8", "int4"])
def test_codec_refresh_budget_with_ties_matches_jax(codec):
    """The codec's refresh quantizes only the kept rows: with a budget
    and tied expiries, rows equal the reference's quantization of the
    whole plane."""
    rng = np.random.default_rng(6)
    V, C, E = 120, 40, 24
    ids, rows, _ = _random_plane(rng, V, C, E)
    exp = np.where(rng.random(C) < 0.5, 3, rng.integers(0, 6, C))
    table = rng.standard_normal((V, E)).astype(np.float32) * 3.0
    n = _refresh_both((ids, rows, exp.astype(np.int32)), table, 4, 5, 6,
                      codec=codec)
    assert n == 6


@pytest.mark.parametrize("codec", [None, "fp16", "int8", "int4"])
def test_seed_plane_matches_jax(codec):
    """The seed takes the refresh without a budget; an empty slot (-1)
    keeps a zero row and is stamped all the same."""
    rng = np.random.default_rng(7)
    V, E = 70, 10
    table = rng.standard_normal((V, E)).astype(np.float32)
    ids = rng.choice(V, 25, replace=False)
    ids[4] = -1
    jp = jpl.seed_plane(jnp.asarray(table), ids, step=3, ttl=5, codec=codec)
    tp = tpl.seed_plane(torch.from_numpy(table), ids, step=3, ttl=5,
                        codec=codec)
    _assert_same(tp, jp)
    assert not tp.rows[4].any() and int(tp.expiry[4]) == 8


@pytest.mark.parametrize("budget", [None, 0, 1, 9, 40, 1_000])
@pytest.mark.parametrize("step", [3, INT32_MAX])
def test_plane_refresh_plain_version(budget, step):
    """The kernel's plain version against a numpy stable argsort of the
    keys: the kept slots, their stamps and rows, and the select-only
    list (slot order, padded with (C, -1)), which leaves the rows as
    they were.  At step = INT32_MAX a due key equals INT32_MAX and ties
    with every slot that is not due."""
    rng = np.random.default_rng(8)
    V, C, E = 80, 40, 6
    ids, rows, exp = _random_plane(rng, V, C, E, empty=0.2)
    if step == INT32_MAX:
        exp[::3] = INT32_MAX
    table = rng.standard_normal((V, E)).astype(np.float32)
    kept = _numpy_kept(ids, exp, step, budget)
    assert len(kept) > 0 or budget == 0
    ttl = 0 if step == INT32_MAX else 4
    cap = C if budget is None else max(0, min(budget, C))

    tp = _tplane(ids, rows, exp)
    n, slot, sel_ids = tk.plane_refresh(tp, torch.from_numpy(table), step,
                                        ttl, budget)
    assert slot is None and sel_ids is None and int(n) == len(kept)
    want_rows, want_exp = rows.copy(), exp.copy()
    want_rows[kept] = table[np.clip(ids[kept], 0, V - 1)]
    want_exp[kept] = step + ttl
    np.testing.assert_array_equal(tp.rows.numpy(), want_rows)
    np.testing.assert_array_equal(tp.expiry.numpy(), want_exp)

    tq = _tplane(ids, rows, exp)
    n, slot, sel_ids = tk.plane_refresh(tq, torch.from_numpy(table), step,
                                        ttl, budget, pull=False)
    assert int(n) == len(kept) and slot.shape == sel_ids.shape == (cap,)
    want_slot = np.full(cap, C, np.int32)
    want_ids = np.full(cap, -1, np.int32)
    want_slot[:len(kept)] = kept
    want_ids[:len(kept)] = ids[kept]
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(sel_ids.numpy(), want_ids)
    np.testing.assert_array_equal(tq.rows.numpy(), rows)
    np.testing.assert_array_equal(tq.expiry.numpy(), want_exp)


def test_staged_pull_matches_staged_gather():
    """staged_pull over a compacted list is the reference's staged_gather
    over the (C,) source array it stands for: slot C skipped, an index
    past the table clamped, and ``src=None`` the identity."""
    rng = np.random.default_rng(9)
    V, C, E = 50, 20, 8
    plane = rng.standard_normal((C, E)).astype(np.float32)
    table = rng.standard_normal((V, E)).astype(np.float32)
    slot = np.array([3, 17, C, 0, 9, C, 12], np.int32)
    src = np.array([5, V + 7, 2, 49, -4, 11, 0], np.int32)
    full = np.full(C, -1, np.int32)
    keep = slot < C
    full[slot[keep]] = np.clip(src[keep], 0, V - 1)
    want = np.asarray(jk.staged_gather(jnp.asarray(plane),
                                       jnp.asarray(table),
                                       jnp.asarray(full)))
    rows = torch.from_numpy(plane.copy())
    before = dict(tk.LAUNCHES)
    out = tk.staged_pull(rows, torch.from_numpy(table),
                         torch.from_numpy(slot), torch.from_numpy(src))
    assert out is rows and tk.LAUNCHES == before     # CPU: no kernel
    np.testing.assert_array_equal(out.numpy(), want)

    pulled = rng.standard_normal((len(slot), E)).astype(np.float32)
    rows = torch.from_numpy(plane.copy())
    tk.staged_pull(rows, torch.from_numpy(pulled), torch.from_numpy(slot))
    want = plane.copy()
    want[slot[keep]] = pulled[keep]
    np.testing.assert_array_equal(rows.numpy(), want)


def test_wrappers_raise():
    P = torch.zeros((4, 8))
    T = torch.zeros((10, 8))
    S = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.staged_pull(P, T, S.long())
    with pytest.raises(ValueError, match="shape"):
        tk.staged_pull(P, T, S, S[:1])
    with pytest.raises(ValueError, match="contiguous"):
        tk.staged_pull(torch.zeros((8, 4)).t(), T, S)
    with pytest.raises(ValueError, match="shape"):
        tk.staged_pull(P, torch.zeros((10, 6)), S)
    plane = _tplane(np.arange(4), np.zeros((4, 8)), np.zeros(4))
    with pytest.raises(ValueError, match="shape"):
        tk.plane_refresh(dataclasses.replace(plane, expiry=S), T, 0, 1)
    with pytest.raises(TypeError):
        tk.plane_refresh(dataclasses.replace(plane, ids=plane.ids.long()),
                         T, 0, 1)
    with pytest.raises(ValueError, match="int32"):
        tk.plane_refresh(plane, T, 2 ** 31, 1)


def _metas(rng, V, W=3, n_batches=10, width=12):
    batches = [rng.integers(-1, V, (4, width)) for _ in range(n_batches)]
    return [meta for _, meta in LookaheadWindow(iter(batches), W)]


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("C,budget", [(8, 4), (16, 24)])
def test_prefetch_step_pulls_in_place(codec, C, budget):
    """Prefetch rounds on a changing table: the port's plane keeps its
    rows tensor from round to round, and equals the reference's (the
    Pallas staged_gather in interpret mode) bit for bit."""
    rng = np.random.default_rng(10)
    V, E = 64, 16
    jplane, tplane = jpf.prefetch_init(C, E), tpf.prefetch_init(C, E)
    rows = tplane.rows
    pulled = 0
    for step, meta in enumerate(_metas(rng, V)):
        table = rng.standard_normal((V, E)).astype(np.float32)
        resident = rng.random(V) < 0.3
        cids, cexp = jpf.prefetch_candidates(meta, step, 2 * budget + 3)
        jplane, jn = jpf.prefetch_step(
            jplane, jnp.asarray(table), jnp.asarray(resident),
            jnp.asarray(cids), jnp.asarray(cexp), step, budget=budget,
            codec=codec, interpret=True)
        tplane, tn = tpf.prefetch_step(
            tplane, torch.from_numpy(table), torch.from_numpy(resident),
            torch.from_numpy(cids), torch.from_numpy(cexp), step,
            budget=budget, codec=codec)
        assert tplane.rows is rows
        assert int(tn) == int(jn), step
        _assert_same(tplane, jplane)
        pulled += int(tn)
    assert pulled > 0


def test_run_serve_warmup_leaves_seeded_planes(monkeypatch):
    """At --ttl-batches 0 every slot is due at step 0: the warm-up's
    refresh runs on a scratch copy, not on a seeded plane."""
    import repro_torch.launch.serve as drv

    seeded, warm = [], []
    real_seed, real_refresh = drv.seed_plane, drv.refresh_plane

    def seed(*a, **k):
        p = real_seed(*a, **k)
        seeded.append((p, [getattr(p, f).clone() for f in FIELDS]))
        return p

    def refresh(plane, *a, **k):
        if not warm:                    # the first refresh: the warm-up
            out = real_refresh(plane, *a, **k)
            warm.append((_storage(plane), int(out[1]),
                         [all(torch.equal(getattr(p, f), v)
                              for f, v in zip(FIELDS, snap))
                          for p, snap in seeded]))
            return out
        return real_refresh(plane, *a, **k)

    monkeypatch.setattr(drv, "seed_plane", seed)
    monkeypatch.setattr(drv, "refresh_plane", refresh)
    args = drv.build_parser().parse_args(
        ["--arch", "wdl-tiny", "--duration", "0.1", "--device", "cpu",
         "--ttl-batches", "0", "--refresh-budget", "8", "--qps", "200"])
    out = drv.run_serve(args)
    assert len(seeded) == args.workers and len(warm) == 1
    storage, n_warm, unchanged = warm[0]
    assert n_warm == 8                  # everything was due at step 0
    assert all(set(storage).isdisjoint(_storage(p)) for p, _ in seeded)
    assert all(unchanged)
    assert out["refresh_rows"] > 0 and out["nonfinite_logits"] == 0
