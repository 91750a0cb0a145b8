"""The whole-solve auction (B independent auctions, each phase's rounds
counted): repro_torch's plain version against the JAX package on the
CPU, and the wrapper's checks.

The reference's ``auction_fixed`` returns only the assignment, so its
rounds are counted by running its own pieces phase by phase: its
``_repair`` and its jitted ``_auction_phase`` (the ``while_loop`` over
``_round_body`` that ``auction_fixed`` runs), at the eps the port's
``_eps`` gives (the assignment is also held against ``auction_fixed``
itself, so a different eps would show).  The bids are one f32
subtraction per value, exact max/argmax and two rounded additions, so
the states are held bit for bit, rounds too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import auction as JA
from repro.core import dispatch_tpu as J
from repro_torch.core import auction as TA
from repro_torch.core import dispatch as T
from repro_torch.kernels import auction as TK


def _costs(kind, rng, B, k, n):
    if kind == "int":
        return rng.integers(0, 20, (B, k, n)).astype(np.float32)
    if kind == "float":
        return rng.random((B, k, n)).astype(np.float32)
    if kind == "tie":
        # blocks of equal rows on a coarse grid, as a cold cache gives
        return np.repeat(rng.integers(0, 3, (B, k // 4, n)), 4,
                         axis=1).astype(np.float32)
    # the decide stage's tie-heavy grid of small costs
    grid = np.round(rng.random((B, k, n)) * 4e3).astype(np.float32)
    return grid / np.float32(4e3) * np.float32(1e-3)


def _fixed_eps(C, n_phases=7):
    Ct = torch.from_numpy(C)
    span = (Ct.amax(dim=(1, 2)) - Ct.amin(dim=(1, 2))).clamp(min=1e-6)
    return torch.stack([T._eps(span, min(p, n_phases - 1))
                        for p in range(n_phases + 2)], dim=1)


def _reference_phases(C, cap, eps, max_rounds):
    """One auction through the reference's repair and phase loop: the
    final state and each phase's rounds."""
    k, n = C.shape
    C = jnp.asarray(C)
    state = (jnp.full((k,), -1, jnp.int32), jnp.zeros((n, cap), jnp.float32),
             jnp.full((n, cap), -1, jnp.int32))
    rounds = []
    for p, e in enumerate(eps):
        e = jnp.float32(e)
        if p:
            state = JA._repair(C, e, state)
        state, r = JA._auction_phase(C, e, state, max_rounds=max_rounds)
        rounds.append(int(r))
    return [np.asarray(x) for x in state], rounds


@pytest.mark.parametrize("kind,B,k,n,cap", [
    ("int", 3, 24, 4, 6), ("float", 3, 24, 4, 6), ("tie", 3, 24, 4, 6),
    ("int", 2, 40, 8, 5), ("float", 2, 40, 8, 5), ("tie", 2, 40, 8, 7),
    ("decide", 4, 256, 4, 64)])
def test_batched_solve_matches_reference_per_worker(kind, B, k, n, cap):
    rng = np.random.default_rng(k + n + len(kind))
    C = _costs(kind, rng, B, k, n)
    eps = _fixed_eps(C)
    n0 = dict(TK.LAUNCHES)
    assign, prices, owners, rounds = TK.auction_solve(torch.from_numpy(C),
                                                      cap, eps, 2000)
    assert TK.LAUNCHES == n0                  # the CPU runs no kernel
    assert (assign.dtype, prices.dtype, owners.dtype, rounds.dtype) == (
        torch.int32, torch.float32, torch.int32, torch.int32)
    assert rounds.shape == (B, 9)
    np.testing.assert_array_equal(
        T.auction_fixed(torch.from_numpy(C), cap).numpy(), assign.numpy())
    for b in range(B):
        (a, p, o), r = _reference_phases(C[b], cap, eps[b].numpy(), 2000)
        np.testing.assert_array_equal(
            assign[b].numpy(), np.asarray(J.auction_fixed(
                jnp.asarray(C[b]), cap)))
        np.testing.assert_array_equal(assign[b].numpy(), a)
        np.testing.assert_array_equal(prices[b].numpy().view(np.int32),
                                      p.view(np.int32))
        np.testing.assert_array_equal(owners[b].numpy(), o)
        assert rounds[b].tolist() == r


def test_batched_solve_counts_rounds_when_a_phase_runs_out():
    rng = np.random.default_rng(4)
    C = _costs("tie", rng, 2, 64, 8)
    eps = torch.full((2, 4), 1e-5) / torch.arange(1, 5)[None]
    assign, prices, owners, rounds = TK.auction_solve(torch.from_numpy(C),
                                                      8, eps, 7)
    assert rounds.max() == 7
    for b in range(2):
        (a, p, o), r = _reference_phases(C[b], 8, eps[b].numpy(), 7)
        assert rounds[b].tolist() == r
        np.testing.assert_array_equal(assign[b].numpy(), a)
        np.testing.assert_array_equal(prices[b].numpy().view(np.int32),
                                      p.view(np.int32))
        np.testing.assert_array_equal(owners[b].numpy(), o)


def test_solve_builds_the_reference_phase_list():
    # the phases at span 19 and eps 1/33: 9.5 / 6**i while above eps
    # (9.5, 1.58, 0.26, 0.044), then three at eps, each rounded to f32
    TK.ROUNDS_LOG = []
    try:
        C = _costs("int", np.random.default_rng(1), 1, 32, 4)[0]
        C[0, 0], C[0, 1] = 0.0, 19.0
        eps = 1.0 / 33
        got, total = TA.auction_solve(torch.from_numpy(C), 8, eps=eps)
        want, want_total = JA.auction_solve(jnp.asarray(C), 8, eps=eps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert total == want_total
        (rounds,) = TK.ROUNDS_LOG
        assert rounds.shape == (1, 4 + 3)
        assert int(rounds.sum()) == total
    finally:
        TK.ROUNDS_LOG = None


def test_rounds_log_is_off_by_default():
    assert TK.ROUNDS_LOG is None
    C = torch.from_numpy(_costs("int", np.random.default_rng(2), 2, 8, 2))
    TK.auction_solve(C, 4, torch.full((2, 1), 0.1), 100)
    assert TK.ROUNDS_LOG is None


def test_solve_wrapper_checks_its_inputs():
    cost = torch.zeros((2, 8, 4))
    eps = torch.full((2, 3), 0.1)
    with pytest.raises(TypeError, match="float32"):
        TK.auction_solve(cost.double(), 2, eps, 10)
    with pytest.raises(TypeError, match="float32"):
        TK.auction_solve(cost, 2, eps.double(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        TK.auction_solve(torch.zeros((2, 4, 8)).transpose(1, 2), 2, eps, 10)
    with pytest.raises(ValueError, match="shape"):
        TK.auction_solve(cost, 2, torch.full((3, 3), 0.1), 10)
    with pytest.raises(ValueError, match="shape"):
        TK.auction_solve(cost[0], 2, eps, 10)
    with pytest.raises(ValueError, match="a worker and a slot"):
        TK.auction_solve(cost, 0, eps, 10)
    with pytest.raises(ValueError, match="devices"):
        TK.auction_solve(cost, 2, eps.to("meta"), 10)
    # above the card's shared memory: the message names the shape
    big = torch.zeros((1, 16384, 8))
    with pytest.raises(ValueError, match=r"k=16384, n=8, capacity=2048 "
                                         r"needs \d+ bytes of shared memory"):
        TK.auction_solve(big, 2048, torch.full((1, 1), 0.1), 10)
    with pytest.raises(ValueError, match="k=70000"):
        TK.auction_solve(torch.zeros((1, 70000, 1)), 1, torch.full((1, 1),
                                                                   0.1), 1)


@pytest.mark.parametrize("k,n,cap,fits,with_cost", [
    (256, 4, 64, True, True),          # the training step's decide
    (256, 8, 32, True, True),          # the S1 simulator's decisions
    (4096, 8, 512, True, False),       # Table 2, 512 a worker
    (8192, 8, 1024, True, False),      # Table 2's largest
    (8192, 16, 1024, False, False)])
def test_solve_shared_memory_budget(k, n, cap, fits, with_cost):
    bare = TK.solve_smem_bytes(k, n, cap, False)
    assert (bare <= TK.SMEM_MAX) == fits
    assert (TK.solve_smem_bytes(k, n, cap, True) <= TK.SMEM_MAX) == with_cost
    # the state alone: assign, slot prices and owners
    assert bare > 4 * k + 8 * n * cap


def test_auction_fixed_takes_one_solve_per_decision():
    rng = np.random.default_rng(8)
    C = torch.from_numpy(_costs("decide", rng, 4, 64, 4))
    TK.ROUNDS_LOG = []
    try:
        got = T.hybrid_dispatch(C, 64, 1.0)
        assert len(TK.ROUNDS_LOG) == 1 and TK.ROUNDS_LOG[0].shape == (4, 9)
    finally:
        TK.ROUNDS_LOG = None
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(J.hybrid_dispatch_jax(
                jnp.asarray(C[b].numpy()), 64, 1.0)))
