"""The reference against the port's stages at tiny sizes on the CPU:
Alg. 1, the exchange, the cache protocol and the training step."""
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
