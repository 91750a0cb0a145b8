"""repro_torch's staging plane and TTL cache planes against the JAX package.

Planes hold ids, expiry steps and copied rows: no arithmetic, so ids,
expiry, refresh counts and rows must match the reference exactly.  With
a wire codec the rows are the codec's round trip of the table rows,
which the port computes in the forms the reference's jitted pull takes:
exact too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pipeline import prefetch as jpf
from repro.serve import plane as jpl
from repro_torch.pipeline import prefetch as tpf
from repro_torch.serve import plane as tpl


def _jplane(ids, rows, exp):
    return jpf.PrefetchPlane(ids=jnp.asarray(ids, jnp.int32),
                             rows=jnp.asarray(rows, jnp.float32),
                             expiry=jnp.asarray(exp, jnp.int32))


def _tplane(ids, rows, exp):
    return tpf.PrefetchPlane(ids=torch.as_tensor(ids, dtype=torch.int32),
                             rows=torch.as_tensor(rows, dtype=torch.float32),
                             expiry=torch.as_tensor(exp, dtype=torch.int32))


def _assert_same(tp, jp):
    np.testing.assert_array_equal(tp.ids.numpy(), np.asarray(jp.ids))
    np.testing.assert_array_equal(tp.expiry.numpy(), np.asarray(jp.expiry))
    np.testing.assert_array_equal(tp.rows.numpy(), np.asarray(jp.rows))


@pytest.mark.parametrize("step", [0, 3, 5])
def test_slot_map_matches_jax(step):
    rng = np.random.default_rng(step)
    V, C = 30, 12
    ids = rng.integers(-1, V, C)
    ids[[2, 7]] = 11          # one id in two slots: the highest live slot wins
    exp = rng.integers(-1, 8, C)
    exp[[2, 7]] = 5           # both live up to and including step 5
    rows = np.zeros((C, 2))
    want = np.asarray(jpf.slot_map(_jplane(ids, rows, exp), V, step))
    got = tpf.slot_map(_tplane(ids, rows, exp), V, step)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[11] == 7


def test_seed_plane_matches_jax():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.choice(40, 15, replace=False)
    jp = jpl.seed_plane(jnp.asarray(table), ids, step=3, ttl=5)
    tp = tpl.seed_plane(torch.from_numpy(table), ids, step=3, ttl=5)
    _assert_same(tp, jp)
    with pytest.raises(ValueError, match="unique"):
        tpl.seed_plane(torch.from_numpy(table), np.array([1, 1]), step=0,
                       ttl=1)
    jq = jpl.seed_plane(jnp.asarray(table), ids, step=3, ttl=5, codec="int8")
    tq = tpl.seed_plane(torch.from_numpy(table), ids, step=3, ttl=5,
                        codec="int8")
    _assert_same(tq, jq)
    assert not torch.equal(tq.rows, tp.rows)     # the rows crossed the wire


@pytest.mark.parametrize("budget", [None, 1, 4, 100])
def test_refresh_plane_matches_jax(budget):
    rng = np.random.default_rng(1)
    V, C, E = 50, 14, 5
    table = rng.normal(size=(V, E)).astype(np.float32)
    ids = rng.choice(V, C, replace=False)
    ids[[3, 9]] = -1                                  # empty slots
    rows = rng.normal(size=(C, E)).astype(np.float32)
    exp = np.array([2, 2, 5, 2, 7, 3, 3, 9, 2, 1, 3, 6, 2, 4])  # many ties
    new_table = table + 100.0
    jp, jn = jpl.refresh_plane(_jplane(ids, rows, exp), jnp.asarray(new_table),
                               4, ttl=3, budget=budget)
    tp, tn = tpl.refresh_plane(_tplane(ids, rows, exp),
                               torch.from_numpy(new_table), 4, ttl=3,
                               budget=budget)
    assert int(tn) == int(jn)
    _assert_same(tp, jp)
    np.testing.assert_array_equal(tpl.plane_ages(tp, 4, ttl=3),
                                  jpl.plane_ages(jp, 4, ttl=3))


def test_refresh_rounds_match_jax():
    """Several budgeted rounds in a row, each on the previous plane."""
    rng = np.random.default_rng(2)
    V, C, E = 60, 20, 3
    table = rng.normal(size=(V, E)).astype(np.float32)
    ids = rng.choice(V, C, replace=False)
    jp = jpl.seed_plane(jnp.asarray(table), ids, step=0, ttl=2)
    tp = tpl.seed_plane(torch.from_numpy(table), ids, step=0, ttl=2)
    jp = dataclasses.replace(jp, expiry=jnp.asarray(
        rng.integers(0, 4, C), jnp.int32))
    tp = dataclasses.replace(tp, expiry=torch.tensor(np.asarray(jp.expiry)))
    for step in range(1, 8):
        table = table * 1.5 + 1.0
        jp, jn = jpl.refresh_plane(jp, jnp.asarray(table), step, ttl=2,
                                   budget=3)
        tp, tn = tpl.refresh_plane(tp, torch.from_numpy(table), step, ttl=2,
                                   budget=3)
        assert int(tn) == int(jn)
        _assert_same(tp, jp)


@pytest.mark.parametrize("codec", ["fp16", "int8", "int4:4"])
def test_codec_planes_match_jax(codec):
    """Seed, then budgeted TTL rounds on a changing table, every pull
    through the codec: ids, expiry, counts and rows exact."""
    rng = np.random.default_rng(3)
    V, C, E = 50, 16, 6
    table = rng.normal(size=(V, E)).astype(np.float32)
    ids = rng.choice(V, C, replace=False)
    jp = jpl.seed_plane(jnp.asarray(table), ids, step=0, ttl=2, codec=codec)
    tp = tpl.seed_plane(torch.from_numpy(table), ids, step=0, ttl=2,
                        codec=codec)
    _assert_same(tp, jp)
    refreshed = 0
    for step in range(1, 6):
        table = table * 1.5 + 0.25
        jp, jn = jpl.refresh_plane(jp, jnp.asarray(table), step, ttl=2,
                                   budget=5, codec=codec)
        tp, tn = tpl.refresh_plane(tp, torch.from_numpy(table), step, ttl=2,
                                   budget=5, codec=codec)
        assert int(tn) == int(jn)
        refreshed += int(tn)
        _assert_same(tp, jp)
    assert refreshed > 0
