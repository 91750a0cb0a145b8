"""Kernel B2 (the row pack) and the ragged exchange over the worker
dimension: repro_torch against the JAX package on the CPU.

The reference's pack kernel runs in interpret mode; the port's wrapper
runs its plain version on CPU tensors.  The exchange is held against
the reference's own model of the shard_map dataflow
(``tests/test_exchange.py::_emulated_exchange``, rebuilt here from the
reference's ``pack_send`` and ``compact_recv``): pack per source, the
all_to_all as "block i on dst j = send block j on src i", compaction per
destination.  Everything is a copy of integers or floats: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch_tpu import dispatch_cap, exchange_budget
from repro.exchange import compact_recv as j_compact, pack_send as j_pack
from repro.kernels.exchange_pack import gather_rows_pallas
from repro_torch.exchange.ragged import (compact_recv, pack_send,
                                         ragged_exchange)
from repro_torch.kernels import exchange_pack as tk
from repro_torch.launch.steps import make_esd_exchange


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("F", [1, 13, 74])
def test_gather_rows_ref_matches_pallas(dtype, F):
    rng = np.random.default_rng(F)
    m, S = 9, 16
    rows = (rng.integers(-50, 50, (m, F)) if dtype == np.int32
            else rng.normal(size=(m, F))).astype(dtype)
    slot = rng.integers(0, m, S).astype(np.int32)
    slot[rng.random(S) < 0.25] = -1
    want = np.asarray(gather_rows_pallas(jnp.asarray(rows), jnp.asarray(slot),
                                         interpret=True))
    n0 = tk.LAUNCHES["gather_rows"]
    got = tk.gather_rows(torch.from_numpy(rows), torch.from_numpy(slot))
    assert got.dtype == torch.from_numpy(rows).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[slot < 0] == -1).all()
    assert tk.LAUNCHES["gather_rows"] == n0     # CPU: no kernel launched


def _reference_exchange(rows, assign, n, budget, out_rows):
    """The reference's pack/compact per worker, the collective emulated."""
    m = rows.shape[1]
    sends, counts, overflow = [], [], 0
    for i in range(n):
        s, c, ov = j_pack(jnp.asarray(rows[i]), jnp.asarray(assign[i]), n,
                          budget)
        sends.append(np.asarray(s))
        counts.append(np.asarray(c))
        overflow += int(ov)
    sends, counts = np.stack(sends), np.stack(counts)
    outs, totals = [], []
    for j in range(n):
        out, total = j_compact(jnp.asarray(sends[:, j]),
                               jnp.asarray(np.minimum(counts[:, j], budget)),
                               out_rows)
        outs.append(np.asarray(out))
        totals.append(int(total))
    return np.stack(outs), np.array(totals), sends, counts, overflow


@pytest.mark.parametrize("case", ["uniform", "slack", "skew_overflow",
                                  "labels"])
def test_ragged_exchange_matches_emulated_reference(case):
    rng = np.random.default_rng(len(case))
    n, m = 4, 8
    cap = dispatch_cap(m, n, 0.5 if case == "slack" else 0.0)
    budget = m // n if case != "slack" else exchange_budget(cap, m)
    out_rows = m if case != "slack" else n * budget
    if case == "uniform":
        assign = np.stack([rng.permutation(np.repeat(np.arange(n), m // n))
                           for _ in range(n)])
    elif case == "slack":       # uneven groups of at most cap = 3 rows
        assign = np.stack([rng.permutation(np.repeat(np.arange(n),
                                                     [3, 2, 1, 2]))
                           for _ in range(n)])
    else:                       # too many rows for worker 0: overflow,
        # for (m, 3) ids and for 1-D labels
        assign = rng.integers(0, n, (n, m))
        assign[:, :5] = 0
    assign = assign.astype(np.int32)
    rows = (rng.random((n, m)).astype(np.float32) if case == "labels"
            else rng.integers(0, 999, (n, m, 3)).astype(np.int32))
    want, totals, sends, counts, overflow = _reference_exchange(
        rows, assign, n, budget, out_rows)
    t_rows, t_assign = torch.from_numpy(rows), torch.from_numpy(assign)
    for i in range(n):
        s, c, ov = pack_send(t_rows[i], t_assign[i], n, budget)
        np.testing.assert_array_equal(s.numpy(), sends[i])
        np.testing.assert_array_equal(c.numpy(), counts[i])
    out, total, recv_counts, ov = ragged_exchange(t_rows, t_assign, budget,
                                                  out_rows)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(total.numpy(), totals)
    np.testing.assert_array_equal(recv_counts.numpy(),
                                  np.minimum(counts.T, budget))
    assert int(ov) == overflow
    assert (overflow > 0) == (case in ("skew_overflow", "labels"))


def test_compact_recv_matches_reference():
    rng = np.random.default_rng(9)
    recv = rng.integers(0, 99, (3, 4, 2)).astype(np.int32)
    cnt = np.array([2, 0, 4], np.int32)
    want, wt = j_compact(jnp.asarray(recv), jnp.asarray(cnt), 7)
    got, gt = compact_recv(torch.from_numpy(recv), torch.from_numpy(cnt), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gt) == int(wt) == 6


def test_padded_route_equals_ragged_under_the_hard_cap():
    """With every worker sending m/n rows to each destination the ragged
    route is the padded all-to-all, bit for bit (as the reference pins)."""
    rng = np.random.default_rng(4)
    n, m = 4, 8
    assign = torch.from_numpy(np.stack(
        [rng.permutation(np.repeat(np.arange(n), m // n)) for _ in range(n)])
        .astype(np.int32))
    padded = make_esd_exchange("padded", n, m)
    ragged = make_esd_exchange("ragged", n, m)
    for rows in (torch.from_numpy(rng.integers(0, 99, (n, m, 5))
                                  .astype(np.int32)),
                 torch.from_numpy(rng.random((n, m)).astype(np.float32))):
        (a, ov_a), (b, ov_b) = padded(rows, assign), ragged(rows, assign)
        assert torch.equal(a, b) and int(ov_a) == int(ov_b) == 0
