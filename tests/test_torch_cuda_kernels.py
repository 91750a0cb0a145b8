"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Imports no JAX, so it runs on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips.  staged_gather and
gather_rows copy rows and must be exact; pooled_lookup sums in the plain
version's order with the multiply and the add rounded apart and must be
exact too; pooled_lookup_staged does the same and is held to rtol =
atol = 1e-5 all the same.  gather_rows_quant and pooled_lookup_quant
compute in their plain versions' forms and must match them bit for bit.
auction_bids takes one subtraction per value, exact max/argmax and two
rounded additions: best_j and bid bit for bit, and the auction solved
with it on the card equals the auction solved on the CPU, rounds too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import auction as ta
from repro_torch.kernels import auction as tb
from repro_torch.kernels import emb_lookup as tk
from repro_torch.kernels import exchange_pack as tp
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


@pytest.mark.parametrize("name", ["int8", "int4", "int8:4", "int4:5",
                                  "fp16"])
@pytest.mark.parametrize("F", [13, 70, 512])
def test_gather_rows_quant_matches_plain(cuda, name, F):
    rng = np.random.default_rng(F)
    m, S = 64, 256
    rows = _spread_rows(rng, m, F, cuda)
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
    n0 = tb.LAUNCHES["auction_bids"]
    got, rounds = ta.auction_dispatch(C, 8, exact=exact, device="cuda",
                                      return_rounds=True)
    want, want_rounds = ta.auction_dispatch(C, 8, exact=exact,
                                            device="cpu", return_rounds=True)
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    assert tb.LAUNCHES["auction_bids"] == n0 + rounds
