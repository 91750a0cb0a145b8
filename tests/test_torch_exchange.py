"""Kernel B2 (the row pack), the exchange's one-launch pack of every
worker and payload, and the ragged exchange over the worker dimension:
repro_torch against the JAX package on the CPU.

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
                                         ragged_exchange,
                                         ragged_exchange_many)
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


def _assignment(rng, case, n, m, budget):
    if case == "uniform":
        return np.stack([rng.permutation(np.arange(m) % n)
                         for _ in range(n)]).astype(np.int32)
    if case == "empty_dest":        # nobody sends to the last worker
        return rng.integers(0, n - 1, (n, m)).astype(np.int32)
    a = rng.integers(0, n, (n, m))  # "overflow": worker 0 over budget
    a[:, : budget + 2] = 0
    return a.astype(np.int32)


@pytest.mark.parametrize("case,budget", [("uniform", 3), ("overflow", 3),
                                         ("empty_dest", 8),
                                         ("overflow", 8)])
def test_pack_send_all_matches_pallas_reference(case, budget):
    """The one-launch pack's plain version (what the CPU runs) against
    the reference's ``pack_send(use_pallas=True)`` worker by worker: ids
    (int32) and dense features (f32) through the Pallas pack in
    interpret mode, labels 1-D; overflow, an empty destination, and a
    budget above m/n (8 > 12/4)."""
    rng = np.random.default_rng(budget + len(case))
    n, m = 4, 12
    assign = _assignment(rng, case, n, m, budget)
    ids = rng.integers(-1, 999, (n, m, 5)).astype(np.int32)
    dense = rng.normal(size=(n, m, 3)).astype(np.float32)
    labels = (rng.random((n, m)) < 0.3).astype(np.float32)
    n0 = dict(tk.LAUNCHES)
    sends, slot_to_row, counts, overflow = tk.pack_send_all(
        torch.from_numpy(assign),
        [torch.from_numpy(a) for a in (ids, dense, labels)], n, budget)
    assert tk.LAUNCHES == n0                     # CPU: no kernel launched
    total_ov = 0
    for i in range(n):
        for q, rows in enumerate((ids, dense, labels)):
            s, c, ov = j_pack(jnp.asarray(rows[i]), jnp.asarray(assign[i]),
                              n, budget, use_pallas=True)
            assert sends[q].dtype == torch.from_numpy(rows).dtype
            np.testing.assert_array_equal(sends[q][i].numpy(), np.asarray(s))
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(c))
        total_ov += int(ov)
        # the slot map names the rows the blocks hold
        stm = slot_to_row[i].numpy()
        np.testing.assert_array_equal(
            sends[0][i].numpy().reshape(n * budget, -1)[stm >= 0],
            ids[i][stm[stm >= 0]])
    assert int(overflow) == total_ov
    assert (total_ov > 0) == (case == "overflow")
    if case == "empty_dest":
        assert not counts[:, -1].any() and (slot_to_row.numpy()[
            :, (n - 1) * budget:] == -1).all()


@pytest.mark.parametrize("case,budget,out_rows", [
    ("uniform", 3, 12), ("overflow", 3, 12), ("empty_dest", 8, 32),
    ("overflow", 8, 32), ("overflow", 8, 10)])
def test_ragged_exchange_many_matches_reference(case, budget, out_rows):
    """ids, dense features and labels over one assignment in one call:
    each output is the reference's exchange of that payload alone, bit
    for bit, with the same totals, counts and overflow."""
    rng = np.random.default_rng(budget * 3 + out_rows + len(case))
    n, m = 4, 12
    assign = _assignment(rng, case, n, m, budget)
    payloads = [rng.integers(-1, 999, (n, m, 5)).astype(np.int32),
                rng.normal(size=(n, m, 3)).astype(np.float32),
                (rng.random((n, m)) < 0.3).astype(np.float32)]
    outs, total, recv_counts, ov = ragged_exchange_many(
        [torch.from_numpy(a) for a in payloads], torch.from_numpy(assign),
        budget, out_rows)
    for got, rows in zip(outs, payloads):
        want, totals, _, counts, overflow = _reference_exchange(
            rows, assign, n, budget, out_rows)
        assert got.dtype == torch.from_numpy(rows).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(total.numpy(), totals)
    np.testing.assert_array_equal(recv_counts.numpy(),
                                  np.minimum(counts.T, budget))
    assert int(ov) == overflow


@pytest.mark.parametrize("mode", ["padded", "ragged"])
def test_route_of_several_arrays_equals_routes_of_each(mode):
    """``route((ids, dense, labels), assign)``, the advance's one call,
    returns what routing each array alone returns."""
    rng = np.random.default_rng(6)
    n, m = 4, 8
    assign = torch.from_numpy(np.stack(
        [rng.permutation(np.repeat(np.arange(n), m // n)) for _ in range(n)])
        .astype(np.int32))
    arrays = (torch.from_numpy(rng.integers(0, 99, (n, m, 5))
                               .astype(np.int32)),
              torch.from_numpy(rng.normal(size=(n, m, 13))
                               .astype(np.float32)),
              torch.from_numpy(rng.random((n, m)).astype(np.float32)))
    route = make_esd_exchange(mode, n, m)
    outs, ov = route(arrays, assign)
    assert isinstance(outs, tuple) and len(outs) == 3 and int(ov) == 0
    for got, a in zip(outs, arrays):
        assert torch.equal(got, route(a, assign)[0])

