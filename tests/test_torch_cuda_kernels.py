"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips.  staged_gather and
gather_rows copy rows and must be exact, as must pack_send_all, the
exchange's one-launch pack (slot maps, counts, overflow and send
blocks); pooled_lookup sums in the plain version's order with the
multiply and the add rounded apart and must be exact too, and so must
alg1_cost, which prices and pools all workers' Alg. 1 in one launch
(against its plain version and the per-worker pooled_lookup route);
pooled_lookup_staged does the same and is held bit for bit at the
serving shapes and around them (and to rtol = atol = 1e-5 in the older
tests).  gather_rows_quant, the pack's quantized kernel and both
layouts of pooled_lookup_quant compute in their plain versions' forms
and must match them bit for bit, on groups whose minimum is -0 or +0
too.
auction_bids takes one subtraction per value, exact max/argmax and two
rounded additions: best_j and bid bit for bit.  auction_solve, the whole
eps-scaled auction in one launch, shares that arithmetic and compares
and subtracts nothing else: assignment, slot prices, slot owners and
each phase's rounds bit for bit, on each route that takes the shape (a
warp an auction, a block an auction), and the solvers on it equal the
CPU's.
flash_attention sums in f32 in another order and with exp2f: outputs
within 2e-5 in f32 and within 1e-2 in bf16 (the outputs' own rounding,
2**-7 relative at |out| ~ 1), lse within 2e-5; the gradients through
its autograd Function within 1e-4 of autograd through plain softmax
attention.  Its bf16 route (wgmma fed by TMA) also rounds P to bf16 for
the P V product, as scaled_dot_product_attention does: it is held to
1e-2, or, where that rounding takes it past 1e-2, to 2e-2 and to no more
than 1.5 times SDPA's own error against the same plain version.  The
backward kernel is held against flash_attention_bwd: f32 within 1e-4;
bf16 (P and dS rounded to bf16 for the tensor cores) against SDPA's
backward, both against the plain version evaluated in f32 on the same
values: the mean error within 1.1 times SDPA's and the max within 2
times.  The max is set by the bf16 rounding of a few of the largest
gradient entries, so its ratio to SDPA's scatters from seed to seed:
for the wgmma kernel of flash_attn_bwd_sm90.cu
scripts/flash_bwd_error_ratio.py measured at most 1.77 on an H100 over
9 seeds at these shapes and at S = 1,000, the mean's at most 1.02.
chip_smoke.py holds the max to 1.5 times SDPA's at the LM path's shape
and around it.  Two bf16 calls and two f32 calls give bitwise-equal
gradients: neither kernel uses atomics.  f32 runs on the tensor cores
too, as three TF32 products a product of its operands' split hi and lo
parts (route "tf32x3", flash_attn_tf32.cu and flash_attn_bwd_tf32.cu):
its forward is held to 2e-5 and its gradients to 1e-4, as the CUDA-core
kernels it replaced were, through any strides.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import auction as ta
from repro_torch.exchange import ragged as tr
from repro_torch.kernels import auction as tb
from repro_torch.kernels import emb_lookup as tk
from repro_torch.kernels import exchange_pack as tp
from repro_torch.kernels import flash_attn as tf
from repro_torch.quant.codecs import quantize_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py also checks the "
                    "kernels on the card)")
    return torch.device("cuda")


def _inputs(rng, V, C, E, B, F, device):
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.3] = -1
    slots = rng.integers(-1, C, (B, F)).astype(np.int32)
    slots[ids < 0] = -1
    src = rng.integers(-1, V, C).astype(np.int32)
    arrays = dict(table=rng.normal(size=(V, E)).astype(np.float32),
                  plane=rng.normal(size=(C, E)).astype(np.float32),
                  src=src, ids=ids, slots=slots,
                  w=rng.random((B, F)).astype(np.float32))
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


@pytest.mark.parametrize("E", [16, 22, 520, 1030])
def test_kernels_match_plain(cuda, E):
    x = _inputs(np.random.default_rng(E), V=300, C=40, E=E, B=9, F=48,
                device=cuda)
    n0 = dict(tk.LAUNCHES)
    got = tk.staged_gather(x["plane"], x["table"], x["src"])
    assert torch.equal(got, tk.staged_gather_ref(x["plane"], x["table"],
                                                 x["src"]))
    for w in (None, x["w"]):
        args = (x["plane"], x["table"], x["slots"], x["ids"], w)
        torch.testing.assert_close(tk.pooled_lookup_staged(*args),
                                   tk.pooled_lookup_staged_ref(*args),
                                   rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["staged_gather"] == n0["staged_gather"] + 1
    assert tk.LAUNCHES["pooled_lookup_staged"] == \
        n0["pooled_lookup_staged"] + 2


def test_unaligned_rows_take_the_scalar_path(cuda):
    """A plane that starts 4 bytes into its storage is not 16-byte
    aligned: the kernels must still read it right."""
    x = _inputs(np.random.default_rng(0), V=64, C=10, E=32, B=4, F=6,
                device=cuda)
    big = torch.zeros(10 * 32 + 1, device=cuda)
    plane = big[1:].view(10, 32)
    plane.copy_(x["plane"])
    assert plane.data_ptr() % 16 != 0
    assert torch.equal(tk.staged_gather(plane, x["table"], x["src"]),
                       tk.staged_gather_ref(plane, x["table"], x["src"]))
    args = (plane, x["table"], x["slots"], x["ids"], None)
    torch.testing.assert_close(tk.pooled_lookup_staged(*args),
                               tk.pooled_lookup_staged_ref(*args),
                               rtol=1e-5, atol=1e-5)


def test_mixed_devices_raise(cuda):
    x = _inputs(np.random.default_rng(1), V=20, C=4, E=8, B=2, F=3,
                device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        tk.staged_gather(x["plane"].cpu(), x["table"], x["src"])


class _Plane:
    def __init__(self, ids, rows, expiry):
        self.ids, self.rows, self.expiry = ids, rows, expiry

    def clone(self):
        return _Plane(self.ids.clone(), self.rows.clone(),
                      self.expiry.clone())


def _refresh_plane_inputs(rng, V, C, E, device, *, cold=False,
                          unaligned=False):
    ids = rng.choice(V, C, replace=False).astype(np.int32)
    ids[rng.random(C) < 0.1] = -1
    exp = (np.full(C, 32, np.int32) if cold
           else rng.integers(-1, 40, C).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(C, E)).astype(np.float32))
    if unaligned:                    # 4 bytes into its storage
        big = torch.zeros(C * E + 1, device=device)
        big[1:].copy_(rows.flatten())
        rows = big[1:].view(C, E)
    plane = _Plane(torch.from_numpy(ids).to(device), rows.to(device),
                   torch.from_numpy(exp).to(device))
    table = torch.from_numpy(rng.normal(size=(V, E)).astype(np.float32))
    return plane, table.to(device)


@pytest.mark.parametrize("C,E,budget,cold", [
    (23_564, 512, 64, True), (23_564, 512, 64, False),
    (23_564, 512, None, False), (23_564, 512, 1, False),
    (3_000, 130, 256, False), (3_000, 130, 257, False),
    (3_000, 16, 2_999, False), (3_000, 16, 5_000, True),
    (3_000, 16, 0, False), (60_000, 8, 64, True), (60_000, 8, 100, False),
    (60_000, 8, None, False), (1, 4, 64, True), (777, 33, 5, False)])
def test_plane_refresh_matches_plain(cuda, C, E, budget, cold):
    """Bit for bit the plain version (rows, expiry, count and, without the
    pull, the list) on both key layouts (shared memory up to 49,152
    slots, L2 above), cold ties, every budget route; one launch with a
    list of at most 256 rows, a staged_pull beside it above."""
    rng = np.random.default_rng(C + E)
    V = max(2 * C, 1_000)
    plane, table = _refresh_plane_inputs(rng, V, C, E, cuda, cold=cold)
    for step, pull in ((32, True), (33, False), (35, True)):
        want = plane.clone()
        n_ref, s_ref, i_ref = tk.plane_refresh_ref(want, table, step, 7,
                                                   budget, pull=pull)
        n0 = dict(tk.LAUNCHES)
        got = plane
        n, s, i = tk.plane_refresh(got, table, step, 7, budget, pull=pull)
        torch.cuda.synchronize()
        ran = {k: tk.LAUNCHES[k] - n0[k] for k in n0 if tk.LAUNCHES[k]
               != n0[k]}
        K = C if budget is None else min(budget, C)
        assert ran == ({"plane_refresh": 1} if not pull or K <= 256 else
                       {"plane_refresh": 1, "staged_pull": 1})
        assert int(n) == int(n_ref) and n.dtype == torch.int32
        for f in ("ids", "rows", "expiry"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        if pull:
            assert s is None and i is None
        else:
            assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
        plane = want                  # the next round from the same state


def test_plane_refresh_edge_cases_match_plain(cuda):
    """Nothing due, step = INT32_MAX (a due key ties with the slots that
    are not due), an unaligned plane (the scalar pull) and E not a
    multiple of 4."""
    rng = np.random.default_rng(11)
    INT32_MAX = 2 ** 31 - 1
    for step, budget, unaligned, E, exp_set in (
            (-5, 64, False, 64, None), (INT32_MAX, 40, False, 64, INT32_MAX),
            (INT32_MAX, None, False, 8, INT32_MAX), (20, 64, True, 32, None),
            (20, None, True, 30, None)):
        plane, table = _refresh_plane_inputs(rng, 5_000, 2_000, E, cuda,
                                             unaligned=unaligned)
        if exp_set is not None:
            plane.expiry[::3] = exp_set
        want = plane.clone()
        n_ref, _, _ = tk.plane_refresh_ref(want, table, step, 0, budget)
        n, _, _ = tk.plane_refresh(plane, table, step, 0, budget)
        torch.cuda.synchronize()
        assert int(n) == int(n_ref)
        for f in ("rows", "expiry"):
            assert torch.equal(getattr(plane, f), getattr(want, f)), f


@pytest.mark.parametrize("C,n,E,with_src,unaligned", [
    (512, 64, 512, True, False), (512, 64, 512, False, False),
    (100, 37, 130, True, False), (4_000, 3_000, 16, True, False),
    (64, 20, 32, True, True), (10, 1, 5, False, False)])
def test_staged_pull_matches_plain(cuda, C, n, E, with_src, unaligned):
    rng = np.random.default_rng(C + n)
    V = 5_000
    plane, table = _refresh_plane_inputs(rng, V, C, E, cuda,
                                         unaligned=unaligned)
    slot = rng.permutation(C)[:n].astype(np.int32)
    slot[rng.random(n) < 0.2] = C                # none
    slot = torch.from_numpy(slot).to(cuda)
    if with_src:
        src = torch.from_numpy(rng.integers(-3, V + 3, n).astype(np.int32)
                               ).to(cuda)
    else:
        src, table = None, table[:n].contiguous()
    want = plane.rows.clone()
    tk.staged_pull_ref(want, table, slot, src)
    n0 = tk.LAUNCHES["staged_pull"]
    out = tk.staged_pull(plane.rows, table, slot, src)
    torch.cuda.synchronize()
    assert out is plane.rows and torch.equal(out, want)
    assert tk.LAUNCHES["staged_pull"] == n0 + 1


@pytest.mark.parametrize("E", [4, 16, 512, 130])
def test_pooled_lookup_matches_plain(cuda, E):
    rng = np.random.default_rng(E + 1)
    x = _inputs(rng, V=300, C=4, E=E, B=37, F=74, device=cuda)
    n0 = tk.LAUNCHES["pooled_lookup"]
    for w in (None, x["w"]):
        got = tk.pooled_lookup(x["table"], x["ids"], w)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.pooled_lookup_ref(x["table"], x["ids"], w))
    assert tk.LAUNCHES["pooled_lookup"] == n0 + 2


def _per_worker_b1(samples, latest, dirty, t):
    from repro_torch.kernels.ops import cost_matrix_sparse_kernel

    return torch.stack([cost_matrix_sparse_kernel(samples[i], latest, dirty,
                                                  t)
                        for i in range(samples.shape[0])])


def _check_alg1(samples, latest, dirty, t):
    n0 = tk.LAUNCHES["alg1_cost"]
    got = tk.alg1_cost(samples, latest, dirty, t)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["alg1_cost"] == n0 + 1
    assert torch.equal(got, tk.alg1_cost_ref(samples, latest, dirty, t))
    assert torch.equal(got, _per_worker_b1(samples, latest, dirty, t))


def test_alg1_cost_matches_plain_at_the_decide_shape(cuda):
    """The cells' decide: 8 workers x 128 samples of 26 ids over 502,000
    rows, Zipf keys, the planes as 30 steps of the cache protocol left
    them (cache ratio 0.08), the paper's links; bit for bit the plain
    version and the per-worker B1 route."""
    from repro_torch.core import dispatch as D
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.quant.codecs import resolve_link_codecs

    n, m, F, V = 8, 128, 26, 502_000
    rng = np.random.default_rng(34)
    cap = int(0.08 * V)
    state = D.esd_sparse_init(n, V, cap, max_ids=m * F, device=cuda)

    def batch():
        ids = (rng.zipf(1.25, (n, m, F)) - 1) % V
        ids[rng.random((n, m, F)) < 0.05] = -1
        return torch.from_numpy(ids.astype(np.int32)).to(cuda)

    for _ in range(30):
        state, _ = D.esd_state_update_sparse(state, D.need_ids_list(batch()),
                                             cap)
    samples = batch()
    assert bool(state.dirty.any()) and bool(state.latest.any())
    bw = DEFAULT_BANDWIDTHS(n)
    for codec in (None, "int8"):
        t = torch.tensor(transmission_time_codec(
            512, bw, resolve_link_codecs("uniform", bw, codec)),
            dtype=torch.float32, device=cuda)
        _check_alg1(samples, state.latest, state.dirty, t)


@pytest.mark.parametrize("n,m,F,V", [(1, 5, 1, 7), (3, 17, 33, 50),
                                     (8, 64, 74, 300), (32, 9, 26, 1000),
                                     (5, 40, 100, 40)])
def test_alg1_cost_matches_plain(cuda, n, m, F, V):
    rng = np.random.default_rng(n * F + V)
    ids = rng.integers(0, V, (n, m, F)).astype(np.int32)
    ids[rng.random((n, m, F)) < 0.25] = -1
    samples = torch.from_numpy(ids).to(cuda)
    t = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    for hit, dirt in ((0.3, 0.5), (1.0, 0.0), (0.0, 0.0), (0.9, 0.9)):
        latest = torch.from_numpy(rng.random((n, V)) < hit).to(cuda)
        dirty = latest & torch.from_numpy(rng.random((n, V)) < dirt).to(cuda)
        _check_alg1(samples, latest, dirty, t)
    # planes with a row stride, as the sparse engine's views are
    wide = torch.zeros((n, V + 1), dtype=torch.bool, device=cuda)
    wide[:, :V] = latest
    want = tk.alg1_cost(samples, latest, dirty, t)
    assert torch.equal(tk.alg1_cost(samples, wide[:, :V], dirty, t), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("F", [1, 13, 74, 40])
def test_gather_rows_matches_plain(cuda, dtype, F):
    rng = np.random.default_rng(F)
    m, S = 64, 256
    rows = torch.from_numpy(rng.normal(size=(m, F)).astype(np.float32)
                            * 100).to(dtype).to(cuda)
    slot = rng.integers(0, m + 5, S).astype(np.int32)   # some past the rows
    slot[rng.random(S) < 0.25] = -1
    slot = torch.from_numpy(slot).to(cuda)
    n0 = tp.LAUNCHES["gather_rows"]
    got = tp.gather_rows(rows, slot)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, tp.gather_rows_ref(rows, slot))
    assert (got[slot < 0] == -1).all()        # -1 in the rows' own dtype
    assert tp.LAUNCHES["gather_rows"] == n0 + 1


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _spread_rows(rng, k, E, device):
    """Rows at many scales and offsets, one of them constant."""
    x = (rng.normal(size=(k, E)) * rng.uniform(1e-3, 1e2, (k, 1))
         + rng.normal(size=(k, 1)) * 10).astype(np.float32)
    x[1] = 0.5
    return torch.from_numpy(x).to(device)


def _signed_zero_rows(rng, k, F, device):
    """_spread_rows with rows whose minimum is a zero of either sign:
    -0 and +0 mixed, all -0, and zeros beside positive values."""
    x = _spread_rows(rng, k, F, "cpu").numpy().copy()
    x[2] = np.where(np.arange(F) % 2, -0.0, 0.0)
    x[3] = -0.0
    x[4] = np.abs(x[4])
    x[4, ::3] = -0.0
    x[4, 1::3] = 0.0
    x[5] = np.where(np.arange(F) % 4 == 1, -0.0, 0.0)
    x[5, ::4] = 3.5
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("name", ["int8", "int4", "int8:4", "int4:5",
                                  "fp16"])
@pytest.mark.parametrize("F", [13, 70, 512])
def test_gather_rows_quant_matches_plain(cuda, name, F):
    rng = np.random.default_rng(F)
    m, S = 64, 256
    rows = _signed_zero_rows(rng, m, F, cuda)
    slot = rng.integers(0, m + 5, S).astype(np.int32)   # some past the rows
    slot[rng.random(S) < 0.25] = -1
    slot = torch.from_numpy(slot).to(cuda)
    n0 = dict(tp.LAUNCHES)
    got = tp.gather_rows_quant(rows, slot, name)
    want = tp.gather_rows_quant_ref(rows, slot, name)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    kernel = "gather_rows" if name == "fp16" else "gather_rows_quant"
    assert tp.LAUNCHES[kernel] == n0[kernel] + 1


@pytest.mark.parametrize("name", ["int8", "int4:5", "fp16"])
@pytest.mark.parametrize("E", [4, 130, 512])
def test_pooled_lookup_quant_matches_plain(cuda, name, E):
    rng = np.random.default_rng(E + 2)
    V, B, F = 300, 37, 74
    codes, scale, zp = quantize_rows(_spread_rows(rng, V, E, cuda), name)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.3] = -1
    ids = torch.from_numpy(ids).to(cuda)
    w = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(cuda)
    kernel = "pooled_lookup" if name == "fp16" else "pooled_lookup_quant"
    n0 = tk.LAUNCHES[kernel]
    for wt in (None, w):
        got = tk.pooled_lookup_quant(codes, scale, zp, ids, wt, codec=name)
        want = tk.pooled_lookup_quant_ref(codes, scale, zp, ids, wt,
                                          codec=name)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
    assert tk.LAUNCHES[kernel] == n0 + 2


@pytest.mark.parametrize("k,n", [(16, 4), (100, 8), (257, 16), (64, 1),
                                 (1000, 33), (5, 100), (8192, 8)])
def test_auction_bids_matches_plain(cuda, k, n):
    rng = np.random.default_rng(k + n)
    cost = rng.random((k, n)).astype(np.float32)
    cost[rng.random((k, n)) < 0.3] = 0.25               # ties in rows
    price = np.round(rng.random(n) * 4).astype(np.float32) / 8
    args = [torch.from_numpy(a).to(cuda)
            for a in (cost, price, rng.random(k) < 0.5)]
    n0 = tb.LAUNCHES["auction_bids"]
    eps = torch.tensor([1.0 / 257], dtype=torch.float32, device=cuda)
    got_j, got_bid = tb.auction_bids(*args, eps)
    want_j, want_bid = tb.auction_bids_ref(*args, eps[0])
    torch.cuda.synchronize()
    assert tb.LAUNCHES["auction_bids"] == n0 + 1
    assert torch.equal(got_j, want_j.to(torch.int32))
    assert _same_bits(got_bid, want_bid)


@pytest.mark.parametrize("exact", [True, False])
def test_auction_on_card_equals_cpu(cuda, exact):
    rng = np.random.default_rng(2)
    C = np.repeat(rng.random((16, 8)), 4, axis=0) * 3.0     # tied rows
    n0 = dict(tb.LAUNCHES)
    got, rounds = ta.auction_dispatch(C, 8, exact=exact, device="cuda",
                                      return_rounds=True)
    want, want_rounds = ta.auction_dispatch(C, 8, exact=exact,
                                            device="cpu", return_rounds=True)
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    # the whole solve is one launch; the bid kernel runs on no solver path
    assert tb.LAUNCHES == {**n0, "auction_solve": n0["auction_solve"] + 1}


def _solve_case(name, rng):
    """(cost (B, k, n) f32, capacity, eps (B, P), max_rounds) as the
    callers build them: auction_fixed's nine phases at the training
    step's decide and at the benchmark cells' (8 workers' auctions of 128
    x 8, capacity 16, costs a worker's misses times its link's row time:
    4 links at 5 Gbps, 4 at 0.5; "cells-war" with rows tied in fours, so
    that phases run out of rounds), _solve's phase list for the simulator
    and Table 2."""
    from repro_torch.core.dispatch import _eps

    def phases(C, eps):
        return [ta.phase_eps(float(C.max() - C.min()), eps)]

    def fixed(C):
        span = torch.from_numpy(C.max(axis=(1, 2)) - C.min(axis=(1, 2)))
        return torch.stack([_eps(span.clamp(min=1e-6), min(p, 6))
                            for p in range(9)], dim=1).numpy()

    if name == "decide":
        C = (np.round(rng.random((4, 256, 4)) * 4e3).astype(np.float32)
             / np.float32(4e3) * np.float32(1e-3))
        return C, 64, fixed(C), 2000
    if name in ("cells", "cells-war"):
        row_s = np.float32(512 * 4 * 8) / np.array([5e9] * 4 + [5e8] * 4,
                                                   np.float32)
        misses = rng.integers(0, 27, (8, 128, 8))
        if name == "cells-war":
            misses = np.repeat(misses[:, :32], 4, axis=1)
        C = misses.astype(np.float32) * row_s
        return C, 16, fixed(C), 2000
    if name == "s1":
        C = np.round(rng.random((1, 256, 8)) * 10_000).astype(np.float32)
        return C, 32, phases(C, 1 / 257), 200_000
    if name == "table2":
        C = rng.random((1, 1024, 8)).astype(np.float32)
        eps = float(C.max() - C.min()) * 1e-3
        return C, 128, phases(C, eps), 200_000
    if name == "one-worker":
        C = rng.random((2, 40, 1)).astype(np.float32)
        return C, 64, [[0.1] * 3] * 2, 50
    # a phase that runs out of rounds
    C = np.repeat(rng.integers(0, 3, (2, 16, 8)), 4, axis=1).astype(np.float32)
    return C, 8, [[1e-5, 5e-6, 1e-6]] * 2, 7


# the route auction_solve takes at each case's shape
_SOLVE_ROUTE = {"decide": "block", "s1": "warp", "table2": "block",
                "one-worker": "block", "runs-out": "warp", "cells": "warp",
                "cells-war": "warp"}


@pytest.mark.parametrize("name", ["decide", "s1", "table2", "one-worker",
                                  "runs-out", "cells", "cells-war"])
def test_auction_solve_matches_plain(cuda, name):
    """Each case through auction_solve (one launch, on the route
    solve_route picks), then on each route that takes its shape: the
    same bits as the plain version, and as each other."""
    C, cap, eps, max_rounds = _solve_case(name, np.random.default_rng(3))
    B, k, n = C.shape
    assert tb.solve_route(k, n, cap) == _SOLVE_ROUTE[name]
    cost = torch.from_numpy(C).to(cuda)
    eps = torch.as_tensor(np.asarray(eps, np.float32), device=cuda)
    n0 = tb.LAUNCHES["auction_solve"]
    got = tb.auction_solve(cost, cap, eps, max_rounds)
    torch.cuda.synchronize()
    assert tb.LAUNCHES["auction_solve"] == n0 + 1
    want = tb.auction_solve_ref(cost, cap, eps, max_rounds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _same_bits(a, b)
    routes = ["block"] + (["warp"] if tb.warp_fits(k, n, cap) else [])
    assert name == "table2" or "warp" in routes
    for route in routes:
        out = tb._launch_solve(cost, cap, eps, max_rounds, route)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert a.dtype == b.dtype and _same_bits(a, b), route
    if name in ("runs-out", "cells-war"):
        assert int(got[3].max()) == max_rounds


def test_training_auction_runs_the_kernel_on_card(cuda, monkeypatch):
    from repro_torch.core import dispatch as td

    def refuse(*a, **k):
        raise AssertionError("the plain auction ran on the card")

    monkeypatch.setattr(tb, "auction_solve_ref", refuse)
    monkeypatch.setattr(tb, "auction_bids_ref", refuse)
    C, cap, _, _ = _solve_case("decide", np.random.default_rng(5))
    n0 = dict(tb.LAUNCHES)
    got = td.hybrid_dispatch(torch.from_numpy(C).to(cuda), 256, 1.0)
    assert tb.LAUNCHES == {**n0, "auction_solve": n0["auction_solve"] + 1}
    monkeypatch.undo()
    want = td.hybrid_dispatch(torch.from_numpy(C), 256, 1.0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("E", [1, 4, 8, 32, 512])
@pytest.mark.parametrize("F", [1, 74, 100])
def test_pooled_lookup_narrow_and_wide_rows_match_plain(cuda, E, F):
    rng = np.random.default_rng(E * 1000 + F)
    x = _inputs(rng, V=300, C=4, E=E, B=37, F=F, device=cuda)
    for w in (None, x["w"]):
        got = tk.pooled_lookup(x["table"], x["ids"], w)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.pooled_lookup_ref(x["table"], x["ids"], w))


@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,causal,dtype", [
    (2, 512, 512, 5, 3, 64, True, torch.bfloat16),
    (2, 512, 512, 5, 3, 64, True, torch.float32),
    (1, 300, 300, 2, 2, 64, True, torch.float32),     # ragged tiles
    (1, 128, 384, 1, 4, 32, False, torch.float32),
    (2, 256, 256, 2, 4, 128, True, torch.bfloat16),
    (1, 100, 40, 3, 1, 128, True, torch.float32),     # Sq > Sk
    (1, 256, 256, 2, 4, 128, False, torch.float32),   # hd 128, full
    (2, 200, 200, 3, 3, 32, True, torch.float32),     # hd 32, G 3
    (1, 40, 100, 2, 3, 64, True, torch.float32),      # Sq < Sk
])
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, KV, G, hd, causal,
                                       dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((B, Sq, KV, G, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    n0 = tf.LAUNCHES["flash_attention"]
    out, lse = tf.flash_attention(q, k, v, causal)
    want, want_lse = tf.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["flash_attention"] == n0 + 1
    assert out.dtype == dtype and out.is_contiguous()
    if dtype == torch.bfloat16:     # the wgmma route: P rounded to bf16
        err = float((out.float() - want.float()).abs().max())
        assert _bf16_within(err, q, k, v, want, causal), err
    else:
        torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


def test_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as views of one fused (B, S, KV, G + 2, hd) projection:
    the kernel reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 256, 2, 5, 64), generator=g, device=cuda)
    q, k, v = qkv[:, :, :, :3], qkv[:, :, :, 3], qkv[:, :, :, 4]
    assert not (q.is_contiguous() or k.is_contiguous())
    out, lse = tf.flash_attention(q, k, v, True)
    want, want_lse = tf.flash_attention_ref(q.contiguous(), k.contiguous(),
                                            v.contiguous(), True)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 1, 1, 48), device=cuda)
    k = torch.zeros((1, 8, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="hd in"):
        tf.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tf.flash_attention(q[..., :32].half(), k[..., :32].half(),
                           k[..., :32].half())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_gradients_on_card(cuda, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    shapes = ((2, 640, 5, 3, 64), (2, 640, 5, 64), (2, 640, 5, 64))
    leaves = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    w = torch.randn(shapes[0], generator=g, device=cuda)
    grads = []
    for plain in (False, True):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        if plain:
            s = torch.einsum("bskgh,btkh->bkgst", q, k) / 8.0
            if causal:
                s = s.masked_fill(~torch.ones(640, 640, dtype=torch.bool,
                                              device=cuda).tril(), -1e30)
            out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), v)
        else:
            out = tf.flash_attn(q, k, v, causal)
        grads.append(torch.autograd.grad((out * w).sum(), (q, k, v)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _sdpa(q, k, v, causal):
    """scaled_dot_product_attention on the (B, H, S, hd) layout, back in
    B8's (B, S, KV, G, hd); the yardstick of the bf16 tolerances."""
    B, S, KV, G, hd = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, S, KV * G, hd).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    return out.transpose(1, 2).reshape(B, S, KV, G, hd)


def _bf16_within(err, q, k, v, ref, causal):
    """1e-2, or up to 2e-2 where the bf16 P of the P V product takes the
    kernel there, as long as it is within 1.5x SDPA's error (only
    computable for Sq == Sk, where SDPA's causal mask is B8's)."""
    if err <= 1e-2:
        return True
    if q.shape[1] != k.shape[1] or err > 2e-2:
        return False
    sdpa_err = float((_sdpa(q, k, v, causal).float() - ref.float())
                     .abs().max())
    return err <= 1.5 * sdpa_err


@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,causal", [
    (1, 300, 300, 2, 3, 64, True),      # ragged S
    (1, 300, 300, 2, 1, 64, False),     # G = 1, full
    (2, 256, 256, 2, 4, 128, True),     # G = 4, hd 128
    (1, 128, 384, 1, 4, 32, False),     # hd 32, Sk > Sq
    (1, 384, 200, 3, 2, 32, True),      # Sq > Sk
    (1, 100, 40, 3, 1, 128, False),     # Sq > Sk, full
    (2, 512, 512, 5, 3, 64, True),      # the LM's heads
])
def test_flash_attention_bf16_wgmma_matches_plain(cuda, B, Sq, Sk, KV, G, hd,
                                                  causal):
    g = torch.Generator(device=cuda).manual_seed(Sq + 7 * hd)
    q = torch.randn((B, Sq, KV, G, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).bfloat16()
    n0, w0 = tf.LAUNCHES["flash_attention"], tf.ROUTE_LAUNCHES["wgmma"]
    out, lse = tf.flash_attention(q, k, v, causal)
    want, want_lse = tf.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["flash_attention"] == n0 + 1
    assert tf.ROUTE_LAUNCHES["wgmma"] == w0 + 1
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    err = float((out.float() - want.float()).abs().max())
    assert _bf16_within(err, q, k, v, want, causal), err
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


def test_flash_attention_bf16_reads_strided_views(cuda):
    """q, k and v as bf16 views of one fused (B, S, KV, G + 2, hd)
    projection: unit inner stride, 16-byte rows, so the wgmma route reads
    them through their strides (TMA for k and v)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((2, 256, 2, 5, 64), generator=g, device=cuda)
    qkv = qkv.bfloat16()
    q, k, v = qkv[:, :, :, :3], qkv[:, :, :, 3], qkv[:, :, :, 4]
    assert not (q.is_contiguous() or k.is_contiguous())
    w0 = tf.ROUTE_LAUNCHES["wgmma"]
    out, lse = tf.flash_attention(q, k, v, True)
    want, want_lse = tf.flash_attention_ref(q.contiguous(), k.contiguous(),
                                            v.contiguous(), True)
    assert tf.ROUTE_LAUNCHES["wgmma"] == w0 + 1
    err = float((out.float() - want.float()).abs().max())
    assert _bf16_within(err, q.contiguous(), k.contiguous(), v.contiguous(),
                        want, True), err
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


def test_flash_attention_bf16_raises_on_a_view_tma_cannot_take(cuda):
    q = torch.zeros((1, 64, 2, 2, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 68), device=cuda,
                    dtype=torch.bfloat16)[..., :64]     # 136-byte rows
    n0 = tf.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="bf16 route cannot read k"):
        tf.flash_attention(q, k, k.contiguous())
    assert tf.LAUNCHES["flash_attention"] == n0


@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,causal,dtype", [
    (1, 300, 300, 2, 3, 64, True, torch.float32),
    (1, 128, 384, 1, 4, 32, False, torch.float32),
    (1, 200, 200, 2, 2, 128, True, torch.float32),
    (1, 100, 40, 3, 1, 64, True, torch.float32),      # Sq > Sk
    (2, 512, 512, 5, 3, 64, True, torch.float32),     # the LM's heads
    (2, 256, 256, 3, 1, 32, True, torch.float32),     # G 1 at hd 32
    (1, 300, 300, 3, 3, 128, False, torch.float32),   # hd 128, full
    (1, 384, 200, 3, 2, 32, False, torch.float32),    # Sq > Sk, full
    (2, 300, 300, 5, 3, 64, True, torch.bfloat16),
    (1, 300, 300, 2, 1, 32, False, torch.bfloat16),
    (1, 256, 256, 2, 4, 128, True, torch.bfloat16),
    (1, 192, 192, 1, 2, 64, False, torch.bfloat16),
    (1, 300, 300, 3, 3, 128, False, torch.bfloat16),  # G 3: 63-row tiles
    (1, 384, 200, 3, 2, 64, True, torch.bfloat16),    # Sq > Sk
    (1, 128, 384, 1, 4, 32, False, torch.bfloat16),   # Sq < Sk
    (1, 2048, 2048, 8, 4, 128, True, torch.bfloat16),  # the grid-fill shape
    (2, 256, 256, 3, 1, 32, True, torch.bfloat16),    # G 1 at hd 32
    (1, 40, 40, 1, 65, 32, True, torch.bfloat16),     # G > 64: head blocks
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, B, Sq, Sk, KV, G, hd,
                                                  causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq + hd + int(causal))
    q = torch.randn((B, Sq, KV, G, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    out, lse = tf.flash_attention(q, k, v, causal)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    n0 = tf.LAUNCHES["flash_attention_bwd"]
    got = tf.flash_attention_backward(q, k, v, out, lse, dout, causal)
    want = tf.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["flash_attention_bwd"] == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.is_contiguous()
    if dtype == torch.float32:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        return
    # bf16: both against the plain backward evaluated in f32 on the same
    # values, so that neither error is counted in whole output ulps
    want = tf.flash_attention_bwd(q.float(), k.float(), v.float(),
                                  out.float(), lse, dout.float(), causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.autograd.grad(_sdpa(*leaves, causal), leaves, dout)
    for name, a, b, s in zip("qkv", got, want, sdpa):
        d, ds = (a.float() - b).abs(), (s.float() - b).abs()
        # the max is a few entries' rounding and its ratio scatters by
        # seed (module docstring); the mean shows the kernel's precision
        assert float(d.mean()) <= 1.1 * float(ds.mean()), (name, "mean")
        assert float(d.max()) <= 2 * float(ds.max()), (name, "max")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """No atomics, every gradient summed in one fixed order: two calls
    give bitwise-equal dq, dk and dv (remat and resume rely on it)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((2, 700, 5, 3, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 700, 5, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, 700, 5, 64), generator=g, device=cuda).to(dtype)
    out, lse = tf.flash_attention(q, k, v, True)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    first = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
    for _ in range(3):
        again = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_flash_attention_bwd_routes_by_dtype(cuda):
    """bf16 runs the wgmma kernel, f32 the split-TF32 kernel, each
    counted on its route and both under the one launch count."""
    g = torch.Generator(device=cuda).manual_seed(17)
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "tf32x3")):
        q = torch.randn((1, 128, 2, 2, 64), generator=g,
                        device=cuda).to(dtype)
        k = torch.randn((1, 128, 2, 64), generator=g, device=cuda).to(dtype)
        out, lse = tf.flash_attention(q, k, k, True)
        n0, r0 = dict(tf.LAUNCHES), dict(tf.BWD_ROUTE_LAUNCHES)
        tf.flash_attention_backward(q, k, k, out, lse, out, True)
        torch.cuda.synchronize()
        assert tf.LAUNCHES["flash_attention_bwd"] == \
            n0["flash_attention_bwd"] + 1
        assert tf.BWD_ROUTE_LAUNCHES == {
            r: r0[r] + (r == route) for r in r0}


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_attention_f32_bwd_is_deterministic_at_every_hd(cuda, hd):
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((1, 333, 3, 3, hd), generator=g, device=cuda)
    k = torch.randn((1, 333, 3, hd), generator=g, device=cuda)
    v = torch.randn((1, 333, 3, hd), generator=g, device=cuda)
    out, lse = tf.flash_attention(q, k, v, True)
    dout = torch.randn(out.shape, generator=g, device=cuda)
    first = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
    again = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_attention_f32_runs_the_tf32x3_route(cuda):
    """Every f32 launch, forward and backward, at every hd and on strided
    views, lands on the split-TF32 route and on no other."""
    g = torch.Generator(device=cuda).manual_seed(21)
    f0, b0 = dict(tf.ROUTE_LAUNCHES), dict(tf.BWD_ROUTE_LAUNCHES)
    n = 0
    for hd in (32, 64, 128):
        qkv = torch.randn((1, 130, 2, 5, hd), generator=g, device=cuda)
        for q, k, v in ((qkv[:, :, :, :3], qkv[:, :, :, 3], qkv[:, :, :, 4]),
                        (qkv[:, :, :, :3].contiguous(),
                         qkv[:, :, :, 3].contiguous(),
                         qkv[:, :, :, 4].contiguous())):
            out, lse = tf.flash_attention(q, k, v, True)
            tf.flash_attention_backward(q, k, v, out, lse, out, True)
            n += 1
    torch.cuda.synchronize()
    assert tf.ROUTE_LAUNCHES == {"wgmma": f0["wgmma"],
                                 "tf32x3": f0["tf32x3"] + n}
    assert tf.BWD_ROUTE_LAUNCHES == {"wgmma": b0["wgmma"],
                                     "tf32x3": b0["tf32x3"] + n}


def test_flash_attention_f32_reads_any_strides(cuda):
    """f32 q, k, v and dout with an innermost stride that is not 1 (and
    rows TMA could not box): the split pass reads them as they are, the
    forward and backward match the plain versions on contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q = torch.randn((1, 2, 3, 64, 150), generator=g,
                    device=cuda).permute(0, 4, 1, 2, 3)   # inner stride 150
    k = torch.randn((1, 2, 64, 150), generator=g,
                    device=cuda).permute(0, 3, 1, 2)
    v = torch.randn((1, 150, 2, 68), generator=g, device=cuda)[..., :64]
    dout = torch.randn((1, 2, 3, 64, 150), generator=g,
                       device=cuda).permute(0, 4, 1, 2, 3)
    c = [t.contiguous() for t in (q, k, v, dout)]
    out, lse = tf.flash_attention(q, k, v, True)
    want, want_lse = tf.flash_attention_ref(*c[:3], True)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)
    got = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
    ref = tf.flash_attention_bwd(*c[:3], out, lse, c[3], True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_flash_attn_backward_runs_the_kernel_on_card(cuda):
    """Through the autograd Function, the card's backward is the kernel:
    the plain version is never called."""
    g = torch.Generator(device=cuda).manual_seed(9)
    leaves = [torch.randn(s, generator=g, device=cuda).bfloat16()
              .requires_grad_()
              for s in ((1, 256, 2, 3, 64), (1, 256, 2, 64),
                        (1, 256, 2, 64))]
    plain, calls = tf.flash_attention_bwd, []
    try:
        tf.flash_attention_bwd = lambda *a, **kw: calls.append(1)
        n0 = dict(tf.LAUNCHES)
        out = tf.flash_attn(*leaves, True)
        grads = torch.autograd.grad(out.float().sum(), leaves)
        torch.cuda.synchronize()
    finally:
        tf.flash_attention_bwd = plain
    assert calls == []
    assert tf.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert tf.LAUNCHES["flash_attention_bwd"] == \
        n0["flash_attention_bwd"] + 1
    assert all(bool(torch.isfinite(x.float()).all()) for x in grads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_kernel_reads_strided_inputs(cuda, dtype):
    """q, k, v as views of one fused projection and dout in the permuted
    layout autograd hands over (hd stride 2): the kernel reads q, k and v
    through their strides and the wrapper copies dout, which it cannot
    read 16 bytes at a time, so the tiles are those of contiguous copies
    and the gradients bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn((1, 200, 2, 5, 64), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[:, :, :, :3], qkv[:, :, :, 3], qkv[:, :, :, 4]
    out, lse = tf.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), True)
    dout = torch.randn((1, 200, 3, 64, 2), generator=g, device=cuda)
    dout = dout.to(dtype).permute(0, 1, 4, 2, 3)      # (1, 200, 2, 3, 64)
    assert dout.stride(-1) == 2
    got = tf.flash_attention_backward(q, k, v, out, lse, dout, True)
    want = tf.flash_attention_backward(q.contiguous(), k.contiguous(),
                                       v.contiguous(), out, lse,
                                       dout.contiguous(), True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,F,E", [(16, 48, 512), (4096, 48, 512),
                                   (9, 48, 510), (5, 300, 130), (3, 1, 4),
                                   (300, 7, 1030), (2, 64, 128)])
def test_pooled_lookup_staged_is_bitwise(cuda, B, F, E):
    """The serving shapes (B = 16 and 4,096 bags of 48 at E = 512) and
    odd ones: rows that are not a multiple of 4 (the scalar layout), more
    valid lookups than a warp's list holds (300), one lookup, a row
    chunk left over (1030); an all-PAD bag pools to zeros."""
    rng = np.random.default_rng(B * 7 + F + E)
    x = _inputs(rng, V=5000, C=64, E=E, B=B, F=F, device=cuda)
    x["ids"][0], x["slots"][0] = -1, -1
    n0 = tk.LAUNCHES["pooled_lookup_staged"]
    for w in (None, x["w"]):
        args = (x["plane"], x["table"], x["slots"], x["ids"], w)
        got = tk.pooled_lookup_staged(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.pooled_lookup_staged_ref(*args))
        assert not got[0].any()
    assert tk.LAUNCHES["pooled_lookup_staged"] == n0 + 2


def test_pooled_lookup_staged_unaligned_is_bitwise(cuda):
    x = _inputs(np.random.default_rng(3), V=64, C=10, E=512, B=16, F=48,
                device=cuda)
    big = torch.zeros(10 * 512 + 1, device=cuda)
    plane = big[1:].view(10, 512)
    plane.copy_(x["plane"])
    assert plane.data_ptr() % 16 != 0
    args = (plane, x["table"], x["slots"], x["ids"], x["w"])
    assert torch.equal(tk.pooled_lookup_staged(*args),
                       tk.pooled_lookup_staged_ref(*args))


def _pack_case(rng, n_src, n, m, kind):
    if kind == "balanced":
        a = np.stack([rng.permutation(np.arange(m) % n)
                      for _ in range(n_src)])
    elif kind == "skew":                  # destination 0 over budget
        a = rng.integers(0, n, (n_src, m))
        a[:, : m // 2] = 0
    else:                                 # nobody sends to the last
        a = rng.integers(0, max(n - 1, 1), (n_src, m))
    payloads = [rng.integers(-9, 999, (n_src, m, 74)).astype(np.int32),
                rng.normal(size=(n_src, m, 13)).astype(np.float32),
                (rng.random((n_src, m)) < 0.3).astype(np.float32),
                rng.normal(size=(n_src, m, 2, 3)).astype(np.float32)]
    return torch.from_numpy(a.astype(np.int32)), [torch.from_numpy(p)
                                                  for p in payloads]


@pytest.mark.parametrize("n_src,n,m,budget,kind", [
    (4, 4, 256, 64, "balanced"), (4, 4, 256, 64, "skew"),
    (4, 4, 256, 128, "empty"), (4, 4, 256, 128, "skew"),
    (3, 5, 77, 9, "skew"), (1, 4, 8, 2, "balanced"),
    (32, 32, 300, 5, "skew"), (2, 3, 1000, 400, "balanced"),
    (4, 4, 256, 0, "balanced"), (2, 2, 0, 4, "balanced")])
def test_pack_send_all_matches_plain(cuda, n_src, n, m, budget, kind):
    assign, payloads = _pack_case(np.random.default_rng(m + budget), n_src,
                                  n, m, kind)
    for k in (4, 3, 0):
        n0 = tp.LAUNCHES["pack_send_all"]
        got = tp.pack_send_all(assign.to(cuda),
                               [p.to(cuda) for p in payloads[:k]], n, budget)
        torch.cuda.synchronize()
        assert tp.LAUNCHES["pack_send_all"] == n0 + 1
        want = tp.pack_send_all_ref(assign, payloads[:k], n, budget)
        assert len(got[0]) == k
        for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.cpu(), b)


def test_pack_send_all_raises_beyond_its_limits(cuda):
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((4, 8, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 32 workers"):
        tp.pack_send_all(a, [p], 33, 1)
    with pytest.raises(ValueError, match="at most 32 workers"):
        tp.pack_send_all(torch.zeros((33, 8), dtype=torch.int32,
                                     device=cuda), [], 4, 1)
    with pytest.raises(ValueError, match="65536 rows"):
        tp.pack_send_all(torch.zeros((1, 65537), dtype=torch.int32,
                                     device=cuda), [], 4, 1)
    with pytest.raises(ValueError, match="4 payloads"):
        tp.pack_send_all(a, [p] * 5, 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tp.pack_send_all(a, [p.transpose(1, 2).contiguous()
                             .transpose(1, 2)], 4, 2)
    with pytest.raises(TypeError, match="int32 or float32"):
        tp.pack_send_all(a, [p.long()], 4, 2)
    with pytest.raises(ValueError, match="several devices"):
        tp.pack_send_all(a, [p.cpu()], 4, 2)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_ragged_exchange_many_on_card_equals_cpu(cuda, codec):
    """ids, dense features and labels over one assignment: one pack
    launch (with the codec, the pack's quantized kernel), the same
    outputs as on the CPU."""
    assign, payloads = _pack_case(np.random.default_rng(11), 4, 4, 256,
                                  "skew")
    payloads = payloads[:3]
    n0 = dict(tp.LAUNCHES)
    got = tr.ragged_exchange_many([p.to(cuda) for p in payloads],
                                  assign.to(cuda), 128, 512, codec=codec)
    torch.cuda.synchronize()
    kernel = "pack_send_all_quant" if codec else "pack_send_all"
    assert tp.LAUNCHES == {**n0, kernel: n0[kernel] + 1}
    want = tr.ragged_exchange_many(payloads, assign, 128, 512, codec=codec)
    for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert torch.equal(a.cpu(), b)



@pytest.mark.parametrize("name", ["int8", "int4", "int8:4", "fp16"])
@pytest.mark.parametrize("F", [1, 13, 16, 17, 512])
def test_pack_send_all_quant_matches_plain(cuda, name, F):
    """The exchange's pack with the dense features on the quantized wire
    (ids and labels exact) in one launch: every output bit for bit
    against the plain version, which packs and quantizes worker by
    worker; overflow and PAD slots; groups whose minimum is -0 or +0;
    half a warp a slot (F <= 16) and a warp a slot (F = 17, 512)."""
    rng = np.random.default_rng(F * 7 + len(name))
    n, m = 4, 96
    assign = rng.integers(0, n, (n, m))
    assign[:, : m // 2] = 0                 # destination 0 over budget
    assign = torch.from_numpy(assign.astype(np.int32))
    dense = torch.stack([_signed_zero_rows(rng, m, F, "cpu")
                         for _ in range(n)])
    payloads = [torch.from_numpy(rng.integers(-9, 999, (n, m, 5))
                                 .astype(np.int32)), dense,
                torch.from_numpy(rng.random((n, m)).astype(np.float32))]
    marks = (False, True, False)
    for budget in (32, 0):
        n0 = dict(tp.LAUNCHES)
        got = tp.pack_send_all(assign.to(cuda),
                               [p.to(cuda) for p in payloads], n, budget,
                               codec=name, quantized=marks)
        torch.cuda.synchronize()
        assert tp.LAUNCHES == {**n0, "pack_send_all_quant":
                               n0["pack_send_all_quant"] + 1}
        want = tp.pack_send_all_ref(assign, payloads, n, budget,
                                    codec=name, quantized=marks)
        assert int(got[3]) == int(want[3]) and (budget == 0
                                                or int(got[3]) > 0)
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert _same_bits(got[0][0].cpu(), want[0][0])
        assert _same_bits(got[0][2].cpu(), want[0][2])
        assert len(got[0][1]) == 3
        for a, b in zip(got[0][1], want[0][1]):
            assert _same_bits(a.cpu(), b)


def test_pack_send_all_quant_launcher_refuses_fp16_groups(cuda):
    """The quantized pack's launcher, called directly, refuses an fp16
    payload of more than one scale group (fp16 writes one scale and zp a
    slot) with cudaErrorInvalidValue, and takes it with one."""
    import ctypes

    from repro_torch.kernels._build import load_library

    lib = load_library("exchange_pack")
    n, m, F = 2, 8, 4
    assign = torch.zeros((n, m), dtype=torch.int32, device=cuda)
    rows = torch.zeros((n, m, F), device=cuda)
    out = torch.empty((n, n, m, F), dtype=torch.float16, device=cuda)
    scale, zp = (torch.empty((n, n, m, 2), device=cuda) for _ in range(2))
    slot_to_row = torch.empty((n, n * m), dtype=torch.int32, device=cuda)
    counts = torch.empty((n, n), dtype=torch.int32, device=cuda)
    overflow = torch.empty((), dtype=torch.int32, device=cuda)
    ptr, one = ctypes.c_void_p * 1, ctypes.c_int * 1

    def launch(groups: int) -> int:
        arrays = [ptr(rows.data_ptr()), ptr(out.data_ptr()), one(F),
                  one(0), ptr(scale.data_ptr()), ptr(zp.data_ptr()),
                  one(F // groups), one(groups)]
        at = [ctypes.addressof(a) for a in arrays]
        rc = lib.pack_send_all_quant_launch(
            assign.data_ptr(), *at[:4], 1, *at[4:], 1.0, 0.0, 1,
            slot_to_row.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            n, n, m, m, torch.cuda.current_stream(cuda).cuda_stream)
        torch.cuda.synchronize()
        return rc

    assert launch(2) == 1                   # cudaErrorInvalidValue
    assert launch(1) == 0


@pytest.mark.parametrize("name", ["int8", "int4", "int8:4"])
@pytest.mark.parametrize("E", [1, 4, 13, 32, 33, 512, 515])
def test_pooled_lookup_quant_layouts_match_plain(cuda, name, E):
    """B5's warp per bag (E <= 32) and warp per (bag, 128 columns)
    (E > 32), bit for bit: PAD ids, ids past the table, an all-PAD bag,
    weights None and given, bags of more valid lookups than a warp's list
    holds (150), a block that does not divide E (int8:4 at 13, 33, 515),
    and rows that are not float4-aligned (a view one float in)."""
    rng = np.random.default_rng(E * 3 + len(name))
    V, B = 300, 37
    codes, scale, zp = quantize_rows(_spread_rows(rng, V, E, cuda), name)
    big = torch.empty(V * E + 1, device=cuda)
    shifted = big[1:].view(V, E)
    shifted.copy_(codes)
    for F in (74, 150):
        ids = rng.integers(0, V + 20, (B, F)).astype(np.int32)
        ids[rng.random((B, F)) < 0.3] = -1
        ids[0] = -1
        ids = torch.from_numpy(ids).to(cuda)
        w = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(cuda)
        for table in (codes, shifted):
            for wt in (None, w):
                n0 = tk.LAUNCHES["pooled_lookup_quant"]
                got = tk.pooled_lookup_quant(table, scale, zp, ids, wt,
                                             codec=name)
                torch.cuda.synchronize()
                assert tk.LAUNCHES["pooled_lookup_quant"] == n0 + 1
                want = tk.pooled_lookup_quant_ref(table, scale, zp, ids, wt,
                                                  codec=name)
                assert _same_bits(got, want)
                assert not got[0].any()


def test_quantized_training_step_packs_once_a_step(cuda):
    """A --codec int8 training step on the card packs the exchange (the
    dense features quantized) in one launch of the pack's quantized
    kernel a step, and never runs gather_rows_quant."""
    from repro_torch.launch.train import build_parser, run_dlrm

    steps = 3
    args = build_parser().parse_args(
        ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker", "8",
         "--steps", str(steps), "--esd-alpha", "1", "--exchange", "ragged",
         "--codec", "int8", "--device", "cuda"])
    n0 = dict(tp.LAUNCHES)
    out = run_dlrm(args)
    assert len(out["metrics"]) == steps
    assert tp.LAUNCHES == {**n0, "pack_send_all_quant":
                           n0["pack_send_all_quant"] + steps}
