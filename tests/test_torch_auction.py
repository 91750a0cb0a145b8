"""The auction's bid phase, the eps-scaled solver and Alg. 2's auction
``Opt``: repro_torch against the JAX package on the CPU.

Both sides get the same numpy inputs.  The bids are one f32 subtraction
per value, exact max/argmax and two rounded additions, so best_j and bid
are held bit for bit; the solvers then take the same decisions, so
assignments and round counts must be equal.  The reference's bid kernel
runs in Pallas interpret mode, as the JAX package's own tests run it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import auction as JA
from repro.core.hybrid import hybrid_dispatch as j_hybrid
from repro.kernels import ops as JO
from repro.kernels.auction import auction_bids as j_bids
from repro.kernels.ref import auction_bids_ref as j_bids_ref
from repro_torch.core import auction as TA
from repro_torch.core.hybrid import hybrid_dispatch as t_hybrid
from repro_torch.kernels import auction as TK
from repro_torch.kernels import ops as TO


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _bid_inputs(rng, k, n):
    cost = rng.random((k, n)).astype(np.float32)
    cost[rng.random((k, n)) < 0.25] = 0.5        # ties inside rows
    price = (rng.random(n) * 0.3).astype(np.float32)
    price[0] = price[-1]                          # tied prices
    unassigned = rng.random(k) < 0.6
    return cost, price, unassigned


@pytest.mark.parametrize("k,n", [(16, 4), (100, 8), (257, 16), (64, 1)])
def test_bids_match_reference_bitwise(k, n):
    rng = np.random.default_rng(k + n)
    cost, price, un = _bid_inputs(rng, k, n)
    eps = np.float32(1.0 / 257)
    args = (jnp.asarray(cost), jnp.asarray(price), jnp.asarray(un), eps)
    want_j, want_bid = j_bids(*args, interpret=True)
    ref_j, ref_bid = j_bids_ref(*args)
    n0 = TK.LAUNCHES["auction_bids"]
    got_j, got_bid = TK.auction_bids(torch.from_numpy(cost),
                                     torch.from_numpy(price),
                                     torch.from_numpy(un),
                                     torch.tensor([eps]))
    assert TK.LAUNCHES["auction_bids"] == n0    # the CPU runs no kernel
    assert got_j.dtype == torch.int32 and got_bid.dtype == torch.float32
    for j, bid in ((want_j, want_bid), (ref_j, ref_bid)):
        np.testing.assert_array_equal(got_j.numpy(), np.asarray(j))
        np.testing.assert_array_equal(_bits(got_bid.numpy()), _bits(bid))
    assert (got_bid.numpy()[~un] == np.float32(TK.NEG)).all()


def test_bids_wrapper_checks_its_inputs():
    cost = torch.zeros((4, 2))
    price = torch.zeros(2)
    un = torch.ones(4, dtype=torch.bool)
    eps = torch.tensor([0.1])
    with pytest.raises(TypeError, match="float32"):
        TK.auction_bids(cost.double(), price, un, eps)
    with pytest.raises(ValueError, match="shape"):
        TK.auction_bids(cost, torch.zeros(3), un, eps)
    with pytest.raises(TypeError, match="bool"):
        TK.auction_bids(cost, price, un.int(), eps)
    with pytest.raises(ValueError, match="contiguous"):
        TK.auction_bids(torch.zeros((2, 4)).T, price, un, eps)
    with pytest.raises(TypeError, match="eps"):
        TK.auction_bids(cost, price, un, 0.1)
    with pytest.raises(ValueError, match="devices"):
        TK.auction_bids(cost, price.to("meta"), un, eps)


def _cost(kind, rng, k, n):
    if kind == "int":
        return rng.integers(0, 20, (k, n)).astype(np.float32)
    if kind == "float":
        return rng.random((k, n)).astype(np.float32)
    # tie-heavy: blocks of equal rows on a coarse grid, as a cold cache gives
    return np.repeat(rng.integers(0, 3, (k // 4, n)), 4,
                     axis=0).astype(np.float32)


@pytest.mark.parametrize("kind", ["int", "float", "tie"])
@pytest.mark.parametrize("k,n,cap", [(24, 4, 6), (40, 8, 5), (64, 8, 8)])
def test_solvers_match_reference(kind, k, n, cap):
    rng = np.random.default_rng(k * 3 + n)
    C = _cost(kind, rng, k, n)
    eps = 1.0 / (k + 1)
    want, want_r = JA.auction_solve(jnp.asarray(C), cap, eps=eps)
    got, got_r = TA.auction_solve(torch.from_numpy(C), cap, eps=eps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_r == want_r
    assert (np.bincount(got.numpy(), minlength=n) <= cap).all()
    want, want_r = JO.auction_solve_pallas(jnp.asarray(C), cap, eps=eps,
                                           interpret=True)
    got, got_r = TO.auction_solve_kernel(torch.from_numpy(C), cap, eps=eps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_r == want_r


def test_solver_respects_max_rounds():
    C = _cost("tie", np.random.default_rng(1), 40, 8)
    want, want_r = JA.auction_solve(jnp.asarray(C), 5, eps=1 / 41,
                                    max_rounds=7)
    got, got_r = TA.auction_solve(torch.from_numpy(C), 5, eps=1 / 41,
                                  max_rounds=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_r == want_r


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind", ["int", "float", "tie", "const"])
def test_dispatch_matches_reference(exact, kind):
    rng = np.random.default_rng(5)
    C = (np.full((32, 4), 2.5) if kind == "const"
         else _cost(kind, rng, 32, 4).astype(np.float64) * 0.37)
    for cap, max_rounds in ((8, 200_000), (10, 200_000), (8, 3)):
        want = JA.auction_dispatch(C, cap, exact=exact, max_rounds=max_rounds)
        got, rounds = TA.auction_dispatch(C, cap, exact=exact,
                                          max_rounds=max_rounds,
                                          device="cpu", return_rounds=True)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
        assert (np.bincount(got, minlength=4) <= cap).all()
        assert rounds >= 0


def test_dispatch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.auction_dispatch(np.eye(4), 1)


@pytest.mark.parametrize("variant", ["paper", "opt_first"])
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_hybrid_auction_matches_reference(variant, alpha):
    rng = np.random.default_rng(9)
    C = rng.random((32, 4)) * 1e-3
    C[:8] = C[8:16]                                   # tied rows
    want = j_hybrid(C, 8, alpha, opt="auction", variant=variant)
    got = t_hybrid(C, 8, alpha, opt="auction", variant=variant,
                   device="cpu")
    np.testing.assert_array_equal(got, want)
