"""The reference against the port's stages at tiny sizes on the CPU:
Alg. 1, the exchange, the cache protocol and the training step; the
cache state against its implementation before it kept counts."""
import sys
import types

import numpy as np
import pytest
import torch

from esdbench.reference.esd import (CacheState, alg1_costs, best_split,
                                    exchange, greedy)
from esdbench.reference.train import RefTrainer, plain_mm, tf32_mm


def _state(rng, n, V):
    latest = rng.random((n, V)) < 0.3
    dirty = latest & (rng.random((n, V)) < 0.5)
    return latest, dirty


def test_alg1_is_the_ports_cost():
    from repro_torch.kernels.ops import cost_matrix_sparse_kernel
    rng = np.random.default_rng(0)
    n, V, m, W = 4, 300, 16, 9
    latest, dirty = _state(rng, n, V)
    s = rng.integers(-1, V, (m, W)).astype(np.int32)
    s[:, 1] = s[:, 0]                         # a repeated id counts once
    t = np.array([1e-6, 2e-6, 1e-5, 3e-5])
    ref = alg1_costs(s, latest, dirty, t)
    port = cost_matrix_sparse_kernel(torch.as_tensor(s),
                                     torch.as_tensor(latest),
                                     torch.as_tensor(dirty),
                                     torch.tensor(t, dtype=torch.float32))
    np.testing.assert_allclose(port.double().numpy(), ref, rtol=1e-6)


def test_exchange_is_the_ports():
    from repro_torch.exchange.ragged import ragged_exchange_many
    rng = np.random.default_rng(1)
    n, m = 4, 8
    assign = np.stack([rng.permutation(np.repeat(np.arange(n), m // n))
                       for _ in range(n)]).astype(np.int32)
    ids = rng.integers(0, 100, (n, m, 5)).astype(np.int32)
    dense = rng.standard_normal((n, m, 3)).astype(np.float32)
    lab = rng.random((n, m)).astype(np.float32)
    outs, *_ = ragged_exchange_many(
        tuple(torch.as_tensor(a) for a in (ids, dense, lab)),
        torch.as_tensor(assign), m // n, m)
    ref = exchange((ids, dense, lab), assign, n)
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o.numpy().reshape(r.shape), r)
    bad = assign.copy()
    bad[0, 0] = (bad[0, 0] + 1) % n
    assert exchange((ids,), bad, n) is None


@pytest.mark.parametrize("m,n,ties", [(16, 4, False), (128, 8, False),
                                      (128, 8, True), (24, 3, True)])
def test_best_split_is_the_least_cost_split(m, n, ties):
    """The least m / n split, against scipy's assignment over each
    worker's column repeated m / n times; never above the greedy."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(m + n + ties)
    cap = m // n
    for _ in range(5):
        C = rng.random((m, n)) * rng.choice([1.0, 10.0, 100.0], (m, 1))
        if ties:
            C = np.round(C * 2) / 2
        x = best_split(C, cap)
        assert (np.bincount(x, minlength=n) == cap).all()
        big = np.repeat(C, cap, axis=1)
        r, c = linear_sum_assignment(big)
        best = C[np.arange(m), x].sum()
        assert best == pytest.approx(big[r, c].sum(), rel=1e-12, abs=1e-12)
        assert best <= C[np.arange(m), greedy(C, cap)].sum() + 1e-9


@pytest.mark.parametrize("capacity", [None, 40])
def test_cache_protocol_is_the_ports(capacity):
    from repro_torch.core.dispatch import (esd_sparse_init,
                                           esd_state_update_sparse,
                                           need_ids_list)
    rng = np.random.default_rng(2)
    n, V, R, F = 3, 120, 6, 5
    ref = CacheState(n, V, capacity)
    port = esd_sparse_init(n, V, capacity, max_ids=R * F)
    for _ in range(8):
        local = rng.integers(-1, V, (n, R, F)).astype(np.int32)
        trained = [np.unique(b[b >= 0]).astype(np.int64) for b in local]
        port, counts = esd_state_update_sparse(
            port, need_ids_list(torch.as_tensor(local)), capacity)
        ours = ref.update(trained)
        for op in ("miss_pull", "update_push", "evict_push"):
            np.testing.assert_array_equal(counts[op].numpy(), ours[op])
        np.testing.assert_array_equal(port.latest.numpy(), ref.latest)
        np.testing.assert_array_equal(port.dirty.numpy(), ref.dirty)


@pytest.mark.parametrize("kind", ["wdl", "dcn"])
def test_training_step_is_the_ports(kind):
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.dlrm import bce_loss, init_params
    from repro_torch.optim import get_optimizer
    pcfg = DLRM_CONFIGS[f"{kind}-tiny"]
    wl = WORKLOADS["tiny"]
    model = init_params(pcfg, wl, torch.Generator().manual_seed(3), "cpu")
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = {"kind": kind, "mlp_dims": list(pcfg.mlp_dims),
           "table_sizes": list(wl.table_sizes), "cross_layers": 2}
    step = make_train_step(model, bce_loss, get_optimizer(
        "rowwise_adagrad", 1e-2))
    V = wl.vocab
    ref = RefTrainer(cfg, weights, np.arange(V), 1e-2, torch.float64,
                     plain_mm)
    rng = np.random.default_rng(4)
    for _ in range(3):
        ids = torch.as_tensor(next(wl.stream(int(rng.integers(99)), 32))[0]
                              .astype(np.int32))
        dense = torch.as_tensor(rng.standard_normal((32, 13)),
                                dtype=torch.float32)
        lab = torch.as_tensor(rng.random(32) < 0.3, dtype=torch.float32)
        lp, lr = float(step(ids, dense, lab)), float(ref.step(ids, dense,
                                                              lab))
        assert lp == pytest.approx(lr, rel=1e-6)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().double().numpy(),
                                   ref.P[name].detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("spec", ["int8", "int4", "int8:64", "fp16"])
def test_codec_is_the_ports(spec):
    from repro_torch.quant import codecs as Q

    from esdbench.reference.codec import fake_quant, row_bytes
    x = torch.randn((40, 100), generator=torch.Generator().manual_seed(5))
    x[0] = 0.0
    x[1, :4] = -0.0
    assert torch.equal(fake_quant(x, spec), Q.fake_quant(x, spec))
    assert row_bytes(100, spec) == Q.row_wire_bytes(100, spec)


def test_tf32_product_rounds_its_operands():
    a = torch.tensor([[1.0 + 2 ** -12]], dtype=torch.float32)
    b = torch.tensor([[1.0]], dtype=torch.float32)
    assert float(tf32_mm(a, b)) == 1.0
    a.requires_grad_(True)
    tf32_mm(a, b).sum().backward()
    assert float(a.grad) == 1.0


class TodaysCacheState:
    """The oracle: the cache state as it was before it kept each
    worker's count (dense (n, vocab) planes, every cache scanned for the
    LRU cut at every step)."""

    def __init__(self, n: int, vocab: int, capacity):
        self.n, self.vocab, self.capacity = n, vocab, capacity
        self.latest = np.zeros((n, vocab), bool)
        self.dirty = np.zeros((n, vocab), bool)
        self.stamp = np.zeros((n, vocab), np.int64)
        self.cached = np.zeros((n, vocab), bool)
        self.step = 0

    def update(self, trained: list) -> dict:
        """One iteration; ``trained[j]`` the distinct ids worker j
        trains.  Returns the (n,) counts of each kind of transfer."""
        n = self.n
        self.step += 1
        # the step touches only the ids someone trains: their columns
        U = np.unique(np.concatenate([np.asarray(v, np.int64)
                                      for v in trained]))
        need = np.zeros((n, U.size), bool)
        for j, ids in enumerate(trained):
            need[j, np.searchsorted(U, ids)] = True
        cnt = need.sum(axis=0)
        latest, dirty = self.latest[:, U], self.dirty[:, U]
        # A. update push
        other = ~(need & (cnt == 1)[None, :])
        pushers = dirty & other
        update_push = pushers.sum(axis=1)
        n_push = pushers.sum(axis=0)
        latest &= ~((n_push > 0)[None, :] & ~pushers)
        latest &= ~(n_push > 1)[None, :]
        dirty &= ~pushers
        # B. miss pull
        miss_pull = (need & ~latest).sum(axis=1)
        latest |= need
        # C. train
        dirty |= need
        latest &= need
        self.latest[:, U], self.dirty[:, U] = latest, dirty
        self.stamp[:, U] = np.where(need, self.step, self.stamp[:, U])
        # the LRU cut: the lowest (stamp, id) go, never this step's ids
        evict_push = np.zeros(n, np.int64)
        for j in range(n):
            self.cached[j, trained[j]] = True
            if self.capacity is None:
                continue
            cand = np.flatnonzero(self.cached[j])
            excess = cand.size - self.capacity
            if excess <= 0:
                continue
            key = self.stamp[j, cand] * self.vocab + cand
            gone = cand[np.argpartition(key, excess - 1)[:excess]]
            gone = gone[self.stamp[j, gone] != self.step]
            evict_push[j] = int((self.latest[j, gone]
                                 & self.dirty[j, gone]).sum())
            self.latest[j, gone] = False
            self.dirty[j, gone] = False
            self.cached[j, gone] = False
        return {"miss_pull": miss_pull, "update_push": update_push,
                "evict_push": evict_push}


@pytest.mark.parametrize("capacity", [None, 60, 150])
def test_cache_state_is_todays(capacity):
    """Random traces of 40 steps over skewed ids: without a cut, with
    one from the first steps, and with one reached midway; counts and
    every plane equal at every step."""
    rng = np.random.default_rng(7 if capacity is None else capacity)
    n, V = 4, 400
    ours, want = CacheState(n, V, capacity), TodaysCacheState(n, V,
                                                              capacity)
    evicted = 0
    for step in range(40):
        trained = [np.unique((rng.zipf(1.3, int(rng.integers(5, 40))) - 1
                              + 13 * j) % V).astype(np.int64)
                   for j in range(n)]
        got, ref = ours.update(trained), want.update(trained)
        for op in ("miss_pull", "update_push", "evict_push"):
            np.testing.assert_array_equal(got[op], ref[op])
        evicted += int(ref["evict_push"].sum())
        for plane in ("latest", "dirty", "stamp", "cached"):
            np.testing.assert_array_equal(getattr(ours, plane),
                                          getattr(want, plane))
        np.testing.assert_array_equal(ours.n_cached,
                                      want.cached.sum(axis=1))
    if capacity is not None:
        assert evicted > 0
        assert (ours.n_cached <= capacity + 40).all()


BIASED = '''The toy kind of the test below: a sample's rows summed, plus a
projection of its dense features and a bias, times a head.'''


def _biased_kind():
    mod = types.ModuleType("esdbench.reference.models.biased", BIASED)

    def leaf_specs(cfg):
        V, E = sum(cfg["table_sizes"]), cfg["embedding_dim"]
        return [("embed", (V, E), 0.01), ("proj", (cfg["n_dense"], E), 0.3),
                ("bias", (E,), 0.1), ("head", (E, 1), 0.25)]

    def forward(P, ids, dense, cfg, mm):
        valid = ids >= 0
        rows = P["embed"][torch.where(valid, ids, 0).long()]
        rows = rows * valid[..., None].to(rows.dtype)
        x = rows.sum(dim=1) + mm(dense.to(rows.dtype), P["proj"]) + P["bias"]
        return mm(x, P["head"])[:, 0]
    mod.leaf_specs, mod.forward = leaf_specs, forward
    return mod


def test_a_bias_leaf_is_checked_as_the_port_trains_it(monkeypatch):
    """A 1-D leaf keeps an accumulator an element in the reference, as in
    the port's row-wise Adagrad: the same steps, the same state, and the
    gradient norm read from either state is the gradient's."""
    from repro_torch.optim import get_optimizer

    from esdbench.program import Program
    monkeypatch.setitem(sys.modules, "esdbench.reference.models.biased",
                        _biased_kind())
    cfg = {"kind": "biased", "table_sizes": [30, 20], "embedding_dim": 6,
           "n_dense": 3}
    g = torch.Generator().manual_seed(11)
    specs = _biased_kind().leaf_specs(cfg)
    weights = {name: torch.randn(shape, generator=g) * scale
               for name, shape, scale in specs}
    ref = RefTrainer(cfg, weights, np.arange(50), 1e-2, torch.float32,
                     plain_mm)
    opt = get_optimizer("rowwise_adagrad", 1e-2)
    params = [weights[name].clone() for name, _, _ in specs]
    state = opt.init(params)
    rng = np.random.default_rng(12)
    for step in range(3):
        ids = torch.as_tensor(rng.integers(-1, 50, (16, 4)))
        dense = torch.as_tensor(rng.standard_normal((16, 3)),
                                dtype=torch.float32)
        lab = torch.as_tensor(rng.random(16) < 0.3, dtype=torch.float32)
        P = {name: p.clone().requires_grad_(True)
             for (name, _, _), p in zip(specs, params)}
        z = ref.forward(P, ids, dense, cfg, plain_mm)
        loss = torch.mean(torch.clamp(z, min=0) - z * lab
                          + torch.log1p(torch.exp(-torch.abs(z))))
        grads = torch.autograd.grad(loss, list(P.values()))
        if step == 0:
            true = {name: float(torch.linalg.vector_norm(gr))
                    for name, gr in zip(P, grads)}
        params, state = opt.update(list(grads), state, params)
        assert float(ref.step(ids, dense, lab)) == pytest.approx(
            float(loss.detach()), rel=1e-6)
        if step == 0:
            program = types.SimpleNamespace(
                names=list(P), step=types.SimpleNamespace(
                    state={"opt": state}),
                model=types.SimpleNamespace(
                    named_parameters=lambda: zip(P, params)))
            port = {k: float(v)
                    for k, v in Program.grad_norms(program).items()}
            assert port == pytest.approx(true, rel=1e-6)
            assert ref.norms_from_acc() == pytest.approx(true, rel=1e-6)
    for (name, _, _), p, a in zip(specs, params, state):
        assert ref.acc[name].shape == a.shape
        np.testing.assert_allclose(ref.acc[name].numpy(), a.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(ref.P[name].detach().numpy(), p.numpy(),
                                   rtol=1e-5, atol=1e-7)
