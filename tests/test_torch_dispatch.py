"""Alg. 2, the sparse cache state machine and row-wise Adagrad:
repro_torch against the JAX package on the CPU.

The solvers are fed the reference's own cost matrix, so assignments are
held exactly even where two cost formulas could differ in a last bit.
The cache state and its counts are integers and booleans: exact.
Row-wise Adagrad takes a mean and a reciprocal square root, whose last
bits may differ between the two libraries: within 1e-6 (SGD too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch_tpu as J
from repro.optim.optimizers import get_optimizer as j_optimizer
from repro_torch.core import dispatch as T
from repro_torch.optim.optimizers import get_optimizer as t_optimizer


def _cost(rng, k, n, ties):
    C = rng.random((k, n)).astype(np.float32) * 1e-3
    if ties:        # a coarse grid: many equal costs, as a cold cache gives
        C = np.round(C * 4e3).astype(np.float32) / np.float32(4e3)
    return C


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("k,n,ties", [(16, 4, False), (32, 4, True),
                                      (24, 2, False), (64, 4, True)])
def test_hybrid_dispatch_matches_reference(alpha, k, n, ties):
    rng = np.random.default_rng(k * 7 + n)
    C = _cost(rng, k, n, ties)
    for cap in (None, k // n + 2):
        want = np.asarray(J.hybrid_dispatch_jax(jnp.asarray(C), k, alpha,
                                                cap=cap))
        got = T.hybrid_dispatch(torch.from_numpy(C), k, alpha, cap=cap)
        np.testing.assert_array_equal(got.numpy(), want)


def test_hybrid_dispatch_batched_equals_per_worker():
    rng = np.random.default_rng(3)
    Cs = np.stack([_cost(rng, 16, 4, i % 2 == 0) for i in range(4)])
    got = T.hybrid_dispatch(torch.from_numpy(Cs), 16, 1.0).numpy()
    for b in range(4):
        want = np.asarray(J.hybrid_dispatch_jax(jnp.asarray(Cs[b]), 16, 1.0))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("ties", [False, True])
def test_heu_and_auction_match_reference(ties):
    rng = np.random.default_rng(11)
    C = _cost(rng, 32, 4, ties)
    np.testing.assert_array_equal(
        T.heu_dispatch(torch.from_numpy(C), 8).numpy(),
        np.asarray(J.heu_dispatch_jax(jnp.asarray(C), 8)))
    for cap in (8, 10):
        np.testing.assert_array_equal(
            T.auction_fixed(torch.from_numpy(C), cap).numpy(),
            np.asarray(J.auction_fixed(jnp.asarray(C), cap)))


def _need_lists(rng, n, V, per_worker, L):
    out = np.full((n, L), -1, np.int32)
    for j in range(n):
        ids = np.unique(rng.zipf(1.3, per_worker) % V).astype(np.int32)
        out[j, :ids.size] = ids
    return out


def test_state_update_sparse_matches_reference():
    n, V, L, capacity = 4, 600, 48, 40
    rng = np.random.default_rng(5)
    js = J.esd_sparse_init(n, V, capacity, max_ids=L)
    ts = T.esd_sparse_init(n, V, capacity, max_ids=L)
    evicted = 0
    for _ in range(6):
        need = _need_lists(rng, n, V, 40, L)
        js, jc = J.esd_state_update_sparse(js, jnp.asarray(need), capacity)
        ts, tc = T.esd_state_update_sparse(ts, torch.from_numpy(need),
                                           capacity)
        for key in ("miss_pull", "update_push", "evict_push"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        for f in ("latest", "dirty", "last_access", "slots", "step"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
        evicted += int(tc["evict_push"].sum())
    assert evicted > 0          # the LRU cut ran


def test_need_ids_list_is_sorted_unique_per_worker():
    s = torch.tensor([[[5, -1, 3], [3, 9, -1]], [[-1, -1, -1], [2, 2, 0]]],
                     dtype=torch.int32)
    got = T.need_ids_list(s)
    assert got.tolist() == [[3, 5, 9, -1, -1, -1], [0, 2, -1, -1, -1, -1]]


def test_dispatch_cap_and_budget_match_reference():
    for m, n, slack in ((8, 4, 0.0), (8, 4, 0.5), (256, 4, 0.2), (3, 4, 0.0)):
        assert T.dispatch_cap(m, n, slack) == J.dispatch_cap(m, n, slack)
        cap = T.dispatch_cap(m, n, slack)
        assert T.exchange_budget(cap, m) == J.exchange_budget(cap, m)


@pytest.mark.parametrize("name", ["rowwise_adagrad", "sgd"])
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(2)
    shapes = [(30, 16), (13, 64), (64,), (5, 3, 8)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt, topt = j_optimizer(name, 1e-2), t_optimizer(name, 1e-2)
    jp, tp = list(map(jnp.asarray, params)), list(map(torch.from_numpy,
                                                      params))
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jp, js = jopt.update(list(map(jnp.asarray, grads)), js, jp)
        tp, ts = topt.update(list(map(torch.from_numpy, grads)), ts, tp)
    assert len(ts) == len(js)
    for a, b in zip(list(tp) + list(ts), list(jp) + list(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
