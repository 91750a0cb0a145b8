"""The window-driven prefetch plane and the dispatching loader:
repro_torch against the JAX package on the CPU.

* ``prefetch_candidates`` (numpy, single- and multi-PS): exact.
* ``prefetch_step`` over rounds that reuse, refresh, expire and reclaim
  slots, against the reference's with ``interpret=True`` (its pull is
  the Pallas ``staged_gather`` in interpret mode; the port's pulls in
  place): ids, expiry and ``n_pulled`` exact, rows bit for bit.  With
  ``codec="int8"`` against the jitted reference (its ``fake_quant``
  path): the same, bit for bit.
* ``staged_membership``: exact.
* ``DispatchingLoader``: the same dispatched items in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.loader import DispatchingLoader as JLoader
from repro.pipeline import prefetch as JP
from repro.pipeline.window import LookaheadWindow, window_meta
from repro.ps import make_partition as j_partition
from repro_torch.data.loader import DispatchingLoader as TLoader
from repro_torch.kernels import emb_lookup
from repro_torch.pipeline import prefetch as TP
from repro_torch.ps.partition import make_partition as t_partition

V, E = 64, 16


def _metas(rng, W, n_batches=8, width=12):
    batches = [rng.integers(-1, V, (4, width)) for _ in range(n_batches)]
    return [meta for _, meta in LookaheadWindow(iter(batches), W)]


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("max_cands", [4, 256])
def test_prefetch_candidates_match_reference(W, max_cands):
    rng = np.random.default_rng(W)
    for step, meta in enumerate(_metas(rng, W)):
        got = TP.prefetch_candidates(meta, step, max_cands)
        want = JP.prefetch_candidates(meta, step, max_cands)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    meta = window_meta([np.array([5, 9]), np.array([2, 5]), np.array([7])])
    jp, tp = j_partition(V, 3, "hashed"), t_partition(V, 3, "hashed")
    for g, w in zip(TP.prefetch_candidates(meta, 10, 6, part=tp),
                    JP.prefetch_candidates(meta, 10, 6, part=jp)):
        np.testing.assert_array_equal(g, w)


def _rounds(seed, C, budget, W=3, codec=None):
    """Prefetch rounds driven by a window over a random stream, with a
    table that changes between rounds: both packages, round by round."""
    rng = np.random.default_rng(seed)
    jplane = JP.prefetch_init(C, E)
    tplane = TP.prefetch_init(C, E)
    pulled = 0
    for step, meta in enumerate(_metas(rng, W, n_batches=10)):
        table = rng.standard_normal((V, E)).astype(np.float32)
        resident = rng.random(V) < 0.3
        cids, cexp = JP.prefetch_candidates(meta, step, 2 * budget + 3)
        jplane, jn = JP.prefetch_step(
            jplane, jnp.asarray(table), jnp.asarray(resident),
            jnp.asarray(cids), jnp.asarray(cexp), step, budget=budget,
            codec=codec, interpret=True)
        tplane, tn = TP.prefetch_step(
            tplane, torch.from_numpy(table), torch.from_numpy(resident),
            torch.from_numpy(cids), torch.from_numpy(cexp), step,
            budget=budget, codec=codec)
        assert int(tn) == int(jn), step
        for key in ("ids", "expiry", "rows"):
            np.testing.assert_array_equal(
                getattr(tplane, key).numpy(),
                np.asarray(getattr(jplane, key)), err_msg=f"{key} {step}")
        for s in (step, step + 2):
            np.testing.assert_array_equal(
                TP.staged_membership(tplane, V, s).numpy(),
                np.asarray(JP.staged_membership(jplane, V, s)))
        pulled += int(tn)
    return pulled


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("C,budget", [(8, 4), (16, 16), (4, 6)])
def test_prefetch_step_matches_reference(seed, C, budget):
    assert _rounds(seed, C, budget) > 0


@pytest.mark.parametrize("seed", range(2))
def test_prefetch_step_codec_matches_reference(seed):
    assert _rounds(seed, 12, 6, codec="int8") > 0


def test_exact_pull_is_one_staged_gather():
    """The pull is one call a round of B3's in-place form, staged_pull
    (the kernel on a card, its plain version here), exact and with the
    codec (over the quantized rows), and the out-of-place staged_gather
    is never called."""
    calls = {"staged_pull": [], "staged_gather": []}
    real = {k: getattr(emb_lookup, f"{k}_ref") for k in calls}

    def counted(name):
        def call(*a):
            calls[name].append(1)
            return real[name](*a)
        return call

    for name in calls:
        setattr(emb_lookup, f"{name}_ref", counted(name))
    try:
        _rounds(0, 8, 4)
        n_exact = len(calls["staged_pull"])
        _rounds(0, 8, 4, codec="int8")
    finally:
        for name in calls:
            setattr(emb_lookup, f"{name}_ref", real[name])
    assert n_exact == 10
    assert len(calls["staged_pull"]) == 20
    assert calls["staged_gather"] == []


def test_prefetch_select_reads_no_rows():
    """The selection half never reads the plane's rows or the table: it
    gives the same plan for any rows."""
    rng = np.random.default_rng(3)
    plane = TP.prefetch_init(8, E)
    cids = torch.tensor([3, 11, 4, 20, -1, -1], dtype=torch.int32)
    cexp = torch.tensor([5, 6, 5, 9, -1, -1], dtype=torch.int32)
    resident = torch.zeros(V, dtype=torch.bool)
    resident[11] = True
    a = TP.prefetch_select(plane, resident, cids, cexp, 0, budget=2)
    plane.rows = torch.from_numpy(rng.standard_normal((8, E))
                                  .astype(np.float32))
    b = TP.prefetch_select(plane, resident, cids, cexp, 0, budget=2)
    for key in ("ids", "expiry", "sel_ids", "sel_slot", "sel_ok",
                "n_pulled"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert int(a.n_pulled) == 2
    assert sorted(a.ids[a.ids >= 0].tolist()) == [3, 4]


def test_dispatching_loader_matches_reference():
    items = list(range(7))
    fn = lambda x: ("dispatched", x * x)
    assert list(TLoader(iter(items), fn)) == list(JLoader(iter(items), fn))
    assert list(TLoader(iter([]), fn, depth=1)) == []
    loader = TLoader(iter(items[:2]), fn)
    assert next(loader) == ("dispatched", 0)
    assert next(loader) == ("dispatched", 1)
    with pytest.raises(StopIteration):
        next(loader)
