"""The quantized wire: repro_torch against the JAX package on the CPU.

The codecs are held against ``repro.quant.codecs`` called under
``jax.jit``, which is how every driver of the reference calls them: XLA
folds ``(hi - lo) / levels`` into a product with the f32 reciprocal and
fuses the dequant ``codes * scale + zp`` into one multiply-add, and the
port takes the same forms, so codes, scales, zero-points and dequantized
values are bitwise equal.  Kernel B4's plain version is bitwise equal to
the Pallas ``gather_rows_quant_pallas`` in interpret mode.  Kernel B5's
plain version is bitwise the pooled sum of the ``fake_quant``-ed table
(the port's own ``pooled_lookup_ref``), and agrees with the Pallas
``pooled_lookup_quant`` in interpret mode, which fuses its multiply-adds
differently, to rtol 1e-6 and an absolute 1e-6 of the largest output
(a few f32 ulps of a sum of six rows).  The quantized ragged exchange
is held against the reference's pack, quantize, dequantize and compact
per worker, the collective emulated: bitwise.  The exchange's one pack
launch with a payload marked as quantized (its plain version) is held
per source against ``gather_rows_quant_pallas`` in interpret mode on
the reference's slot map, bitwise.  Groups whose minimum is a zero take
-0 as their zero-point where they hold a -0, as the reference's ``min``
does, and every code is +0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost import transmission_time_codec as j_time_codec
from repro.core.dispatch_tpu import dispatch_cap, exchange_budget
from repro.exchange import compact_recv as j_compact, pack_send as j_pack
from repro.kernels.emb_lookup import pooled_lookup_quant as j_pooled_quant
from repro.kernels.exchange_pack import gather_rows_quant_pallas
from repro.quant import codecs as J
from repro_torch.core.cost import transmission_time_codec as t_time_codec
from repro_torch.exchange.ragged import ragged_exchange, ragged_exchange_quant
from repro_torch.kernels import emb_lookup as tk
from repro_torch.kernels import exchange_pack as tp
from repro_torch.launch.steps import make_esd_exchange
from repro_torch.quant import codecs as T

CODECS = ["fp16", "int8", "int4", "int8:4", "int4:5"]

j_quantize = jax.jit(J.quantize_rows, static_argnums=1)
j_dequantize = jax.jit(J.dequantize_rows, static_argnums=3)
j_fake = jax.jit(J.fake_quant, static_argnums=1)
j_ste = jax.jit(J.ste, static_argnums=1)
j_feedback = jax.jit(J.quantize_with_feedback, static_argnums=2)


def _bits_equal(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _rows(rng, k=40, E=13):
    """Rows at many scales and offsets, plus a constant row and a PAD
    fill row (-1), which must round-trip exactly."""
    x = (rng.normal(size=(k, E)) * rng.uniform(1e-3, 1e2, (k, 1))
         + rng.normal(size=(k, 1)) * 10).astype(np.float32)
    x[3] = 0.25
    x[4] = -1.0
    return x


@pytest.mark.parametrize("name", CODECS)
def test_codec_tensor_functions_match_jit(name):
    rng = np.random.default_rng(len(name))
    x = _rows(rng)
    c = T.get_codec(name)
    jc = J.get_codec(name)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for got, want, what in zip(T.quantize_rows(tx, c), j_quantize(jx, jc),
                               ("codes", "scale", "zp")):
        _bits_equal(got, want, f"{name} {what}")
    fq = T.fake_quant(tx, c)
    _bits_equal(fq, j_fake(jx, jc), f"{name} fake_quant")
    # constant rows, the PAD fill row among them, round-trip exactly
    np.testing.assert_array_equal(fq.numpy()[[3, 4]], x[[3, 4]])
    _bits_equal(T.ste(tx, c), j_ste(jx, jc), f"{name} ste")
    r = (rng.normal(size=x.shape) * 0.1).astype(np.float32)
    for got, want, what in zip(
            T.quantize_with_feedback(tx, torch.from_numpy(r), c),
            j_feedback(jx, jnp.asarray(r), jc), ("g_hat", "residual")):
        _bits_equal(got, want, f"{name} {what}")


@pytest.mark.parametrize("name", CODECS)
def test_ste_gradient_is_the_identity(name):
    rng = np.random.default_rng(7)
    x = _rows(rng, k=6, E=9)
    w = rng.normal(size=x.shape).astype(np.float32)
    c = T.get_codec(name)
    tx = torch.from_numpy(x).requires_grad_(True)
    (T.ste(tx, c) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(J.ste(a, J.get_codec(name))
                                      * jnp.asarray(w)))(jnp.asarray(x))
    _bits_equal(tx.grad, want, f"{name} ste gradient")
    np.testing.assert_array_equal(tx.grad.numpy(), w)


@pytest.mark.parametrize("E", [1, 7, 8, 13])
def test_int4_packing_matches_reference(E):
    rng = np.random.default_rng(E)
    codes = rng.integers(0, 16, (5, E)).astype(np.float32)
    want = np.asarray(J.pack_int4(jnp.asarray(codes)))
    got = T.pack_int4(torch.from_numpy(codes))
    _bits_equal(got, want, "pack_int4")
    assert got.shape[-1] == T.wire_row_bytes(E, "int4")
    back = T.unpack_int4(got, E)
    _bits_equal(back, J.unpack_int4(jnp.asarray(want), E), "unpack_int4")
    np.testing.assert_array_equal(back.numpy(), codes.astype(np.uint8))


@pytest.mark.parametrize("name", [None, "none"] + CODECS + ["int8:64"])
def test_byte_accounting_and_pricing_match_reference(name):
    c_t, c_j = T.get_codec(name), J.get_codec(name)
    assert T.codec_name(name) == J.codec_name(name)
    assert (c_t is None) == (c_j is None)
    if c_t is not None:
        assert (c_t.kind, c_t.block, c_t.bits, c_t.levels, c_t.name) == (
            c_j.kind, c_j.block, c_j.bits, c_j.levels, c_j.name)
    for E in (1, 13, 16, 512, 513):
        for fn in ("wire_row_bytes", "meta_row_bytes", "row_wire_bytes"):
            assert getattr(T, fn)(E, name) == getattr(J, fn)(E, name), (fn, E)
    for bw in (np.array([1e8, 2e8, 5e7, 1e9]),
               np.array([[1e8, 3e8], [2e8, 2e8], [5e7, 9e8]])):
        for policy in ("uniform", "bandwidth"):
            want = J.resolve_link_codecs(policy, bw, name)
            got = T.resolve_link_codecs(policy, bw, name)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
                assert got.dtype == object
            for E in (16, 512):
                np.testing.assert_array_equal(
                    t_time_codec(E, bw, got), j_time_codec(E, bw, want))
    with pytest.raises(ValueError, match="shape"):
        t_time_codec(8, np.ones(2), np.array(["int8"] * 3, object))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("F", [13, 20])
def test_gather_rows_quant_ref_matches_pallas(name, F):
    rng = np.random.default_rng(F)
    m, S = 11, 24
    rows = _rows(rng, k=m, E=F)
    slot = rng.integers(0, m, S).astype(np.int32)
    slot[rng.random(S) < 0.25] = -1
    want = gather_rows_quant_pallas(jnp.asarray(rows), jnp.asarray(slot),
                                    codec=J.get_codec(name), interpret=True)
    n0 = dict(tp.LAUNCHES)
    got = tp.gather_rows_quant(torch.from_numpy(rows), torch.from_numpy(slot),
                               name)
    for g, w, what in zip(got, want, ("codes", "scale", "zp")):
        _bits_equal(g, w, f"{name} F={F} {what}")
    assert tp.LAUNCHES == n0                 # CPU: no kernel launched
    if name != "fp16":                       # PAD slots: scale 1, zp fill
        pad = slot < 0
        assert (got[0].numpy()[pad] == 0).all()
        assert (got[1].numpy()[pad] == 1).all()
        assert (got[2].numpy()[pad] == -1).all()


@pytest.mark.parametrize("name", CODECS)
def test_pooled_lookup_quant_matches_reference(name):
    rng = np.random.default_rng(3)
    V, E, B, F = 30, 16, 5, 6
    table = _rows(rng, k=V, E=E)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.25] = -1
    w = rng.random((B, F)).astype(np.float32)
    codes, scale, zp = j_quantize(jnp.asarray(table), J.get_codec(name))
    n0 = tk.LAUNCHES["pooled_lookup_quant"]
    args = [torch.from_numpy(np.array(a)) for a in (codes, scale, zp, ids)]
    for wt in (None, w):
        tw = None if wt is None else torch.from_numpy(wt)
        got = tk.pooled_lookup_quant(*args, tw, codec=name)
        fq = T.fake_quant(torch.from_numpy(table), name)
        _bits_equal(got, tk.pooled_lookup_ref(fq, args[3], tw).numpy(),
                    f"{name} vs the pooled fake_quant table")
        want = j_pooled_quant(codes, scale, zp, jnp.asarray(ids),
                              None if wt is None else jnp.asarray(wt),
                              codec=J.get_codec(name), interpret=True)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert tk.LAUNCHES["pooled_lookup_quant"] == n0


def _reference_exchange_quant(rows, assign, n, budget, out_rows, codec):
    """The reference's pack, quantize (jit), dequantize (jit) and compact
    per worker, the all_to_all emulated."""
    E = rows.shape[-1]
    codes, scale, zp, counts, overflow = [], [], [], [], 0
    for i in range(n):
        s, cnt, ov = j_pack(jnp.asarray(rows[i]), jnp.asarray(assign[i]), n,
                            budget)
        q = j_quantize(s.reshape(n * budget, E), codec)
        for acc, a in zip((codes, scale, zp), q):
            acc.append(np.asarray(a).reshape((n, budget, -1)))
        counts.append(np.asarray(cnt))
        overflow += int(ov)
    codes, scale, zp, counts = map(np.stack, (codes, scale, zp, counts))
    outs, totals = [], []
    for j in range(n):
        deq = j_dequantize(jnp.asarray(codes[:, j]), jnp.asarray(scale[:, j]),
                           jnp.asarray(zp[:, j]), codec)
        out, total = j_compact(deq, jnp.asarray(np.minimum(counts[:, j],
                                                           budget)), out_rows)
        outs.append(np.asarray(out))
        totals.append(int(total))
    return np.stack(outs), np.array(totals), counts, overflow


@pytest.mark.parametrize("name", ["int8", "int4:5", "fp16"])
@pytest.mark.parametrize("case", ["uniform", "slack", "skew_overflow"])
def test_ragged_exchange_quant_matches_emulated_reference(case, name):
    rng = np.random.default_rng(len(case) + len(name))
    n, m, E = 4, 8, 13
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
    else:                       # too many rows for worker 0: overflow
        assign = rng.integers(0, n, (n, m))
        assign[:, :5] = 0
    assign = assign.astype(np.int32)
    rows = np.stack([_rows(rng, k=m, E=E) for _ in range(n)])
    want, totals, counts, overflow = _reference_exchange_quant(
        rows, assign, n, budget, out_rows, J.get_codec(name))
    out, total, recv_counts, ov = ragged_exchange_quant(
        torch.from_numpy(rows), torch.from_numpy(assign), budget, name,
        out_rows)
    _bits_equal(out, want, f"{case} {name} exchanged rows")
    np.testing.assert_array_equal(total.numpy(), totals)
    np.testing.assert_array_equal(recv_counts.numpy(),
                                  np.minimum(counts.T, budget))
    assert int(ov) == overflow
    assert (overflow > 0) == (case == "skew_overflow")
    if case == "slack":         # PAD rows past each valid prefix: fill
        for j in range(n):
            assert (out[j, totals[j]:] == -1).all()


def test_codec_route_quantizes_only_float_rows():
    """Sample ids (int32) and labels (one float per sample) travel exact;
    the dense features go through the quantized wire."""
    rng = np.random.default_rng(5)
    n, m = 4, 8
    assign = torch.from_numpy(np.stack(
        [rng.permutation(np.repeat(np.arange(n), m // n)) for _ in range(n)])
        .astype(np.int32))
    exact = make_esd_exchange("ragged", n, m)
    quant = make_esd_exchange("ragged", n, m, codec="int8")
    ids = torch.from_numpy(rng.integers(-1, 99, (n, m, 5)).astype(np.int32))
    labels = torch.from_numpy((rng.random((n, m)) < 0.3).astype(np.float32))
    dense = torch.from_numpy(rng.normal(size=(n, m, 13)).astype(np.float32))
    for a in (ids, labels):
        assert torch.equal(quant(a, assign)[0], exact(a, assign)[0])
    got = quant(dense, assign)[0]
    assert torch.equal(got, ragged_exchange_quant(dense, assign, m // n,
                                                  "int8", m)[0])
    assert not torch.equal(got, exact(dense, assign)[0])
    assert torch.equal(ragged_exchange_quant(dense, assign, 2, None)[0],
                       ragged_exchange(dense, assign, 2)[0])
    with pytest.raises(ValueError, match="ragged"):
        make_esd_exchange("padded", n, m, codec="int8")


def _signed_zero_rows(rng, k, E):
    """_rows plus rows whose minimum is a zero of either sign: -0 and +0
    mixed, all -0, zeros beside positive values."""
    x = _rows(rng, k=k, E=E)
    x[5] = np.where(np.arange(E) % 2, -0.0, 0.0)
    x[6] = -0.0
    x[7] = np.abs(x[7])
    x[7, ::3] = -0.0
    x[7, 1::3] = 0.0
    return x


@pytest.mark.parametrize("name", ["int8", "int4", "int8:4", "int4:5"])
def test_signed_zero_groups_match_reference(name):
    """A group whose minimum is a zero: zero-point -0 where it holds a
    -0 (+0 otherwise), codes +0, as the reference's jitted codec and its
    Pallas pack give them."""
    rng = np.random.default_rng(len(name))
    rows = _signed_zero_rows(rng, 12, 13)
    c = J.get_codec(name)
    got = T.quantize_rows(torch.from_numpy(rows), name)
    for g, w, what in zip(got, j_quantize(jnp.asarray(rows), c),
                          ("codes", "scale", "zp")):
        _bits_equal(g, w, f"{name} quantize_rows {what}")
    assert np.signbit(got[2][6].numpy()).all()       # all -0: zp -0
    assert not np.signbit(got[0].numpy()).any()      # codes never -0
    # fake_quant skips the zero's sign, which changes no dequantized bit
    _bits_equal(T.fake_quant(torch.from_numpy(rows), name),
                j_fake(jnp.asarray(rows), c), f"{name} fake_quant")
    _bits_equal(T.fake_quant(torch.from_numpy(rows), name),
                T.dequantize_rows(*got, name).numpy(),
                f"{name} fake_quant = dequantize(quantize_rows)")
    slot = np.arange(-1, 12, dtype=np.int32)
    want = gather_rows_quant_pallas(jnp.asarray(rows), jnp.asarray(slot),
                                    codec=c, interpret=True)
    got = tp.gather_rows_quant(torch.from_numpy(rows), torch.from_numpy(slot),
                               name)
    for g, w, what in zip(got, want, ("codes", "scale", "zp")):
        _bits_equal(g, w, f"{name} gather_rows_quant {what}")


def _jax_slot_map(assign, n, budget):
    """The reference's slot map for the quantized pack
    (``repro/exchange/ragged.py:ragged_exchange_quant``, use_pallas)."""
    a = jnp.asarray(assign)
    m = a.shape[0]
    counts = jnp.zeros((n,), jnp.int32).at[a].add(1, mode="drop")
    starts = jnp.cumsum(counts) - counts
    order = jnp.argsort(a, stable=True)
    rank = jnp.zeros((m,), jnp.int32).at[order].set(
        jnp.arange(m, dtype=jnp.int32))
    pos = rank - starts[a]
    slot = jnp.where(pos < budget, a * budget + pos, n * budget)
    return jnp.full((n * budget,), -1, jnp.int32).at[slot].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop")


@pytest.mark.parametrize("name", ["int8", "int4", "int8:4", "fp16"])
@pytest.mark.parametrize("case,budget", [("uniform", 3), ("overflow", 3),
                                         ("overflow", 8)])
def test_pack_send_all_quant_ref_matches_pallas(name, case, budget):
    """The exchange's one pack with the dense features marked as
    quantized (ids and labels exact), its plain version as the CPU runs
    it: per source, the quantized blocks equal ``gather_rows_quant_pallas``
    (interpret mode) on the reference's slot map, codes, scale and zp bit
    for bit, PAD slots and an overflowing link included; the exact
    payloads equal the reference's Pallas pack."""
    rng = np.random.default_rng(budget + len(case) + len(name))
    n, m, F = 4, 12, 13
    if case == "uniform":
        assign = np.stack([rng.permutation(np.arange(m) % n)
                           for _ in range(n)])
    else:                       # worker 0 over its budget
        assign = rng.integers(0, n, (n, m))
        assign[:, : budget + 2] = 0
    assign = assign.astype(np.int32)
    ids = rng.integers(-1, 999, (n, m, 5)).astype(np.int32)
    dense = np.stack([_signed_zero_rows(rng, m, F) for _ in range(n)])
    labels = (rng.random((n, m)) < 0.3).astype(np.float32)
    n0 = dict(tp.LAUNCHES)
    sends, stm, counts, overflow = tp.pack_send_all(
        torch.from_numpy(assign),
        [torch.from_numpy(a) for a in (ids, dense, labels)], n, budget,
        codec=name, quantized=(False, True, False))
    assert tp.LAUNCHES == n0                 # CPU: no kernel launched
    codes, scale, zp = sends[1]
    G = 1 if name == "fp16" else -(-F // T.group_size(F, T.get_codec(name)))
    assert codes.shape == (n, n, budget, F) and scale.shape == (n, n, budget,
                                                                G)
    total_ov = 0
    for i in range(n):
        want_stm = _jax_slot_map(assign[i], n, budget)
        np.testing.assert_array_equal(stm[i].numpy(), np.asarray(want_stm))
        want = gather_rows_quant_pallas(jnp.asarray(dense[i]), want_stm,
                                        codec=J.get_codec(name),
                                        interpret=True)
        for g, w, what in zip(sends[1], want, ("codes", "scale", "zp")):
            _bits_equal(g[i].reshape(n * budget, -1), w,
                        f"{name} {case} source {i} {what}")
        for q, rows in ((0, ids), (2, labels)):
            s, c, ov = j_pack(jnp.asarray(rows[i]), jnp.asarray(assign[i]),
                              n, budget, use_pallas=True)
            np.testing.assert_array_equal(sends[q][i].numpy(), np.asarray(s))
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(c))
        total_ov += int(ov)
    assert int(overflow) == total_ov and (total_ov > 0) == (case ==
                                                             "overflow")
    pad = stm.numpy().reshape(n, n, budget) < 0
    assert pad.any() == (case == "overflow")  # the other links run short
    if name != "fp16":                       # PAD slots: scale 1, zp fill
        assert (codes.numpy()[pad] == 0).all()
        assert (scale.numpy()[pad] == 1).all() and (zp.numpy()[pad] == -1
                                                    ).all()


def test_pack_send_all_refuses_marks_it_cannot_honour():
    """A quantized mark needs a codec and (n_src, m, F) f32 rows, and
    one mark a payload."""
    assign = torch.zeros((2, 4), dtype=torch.int32)
    ids = torch.zeros((2, 4, 3), dtype=torch.int32)
    dense = torch.zeros((2, 4, 3))
    labels = torch.zeros((2, 4))
    for payloads, codec, marks in (([ids], "int8", (True,)),
                                   ([labels], "int8", (True,)),
                                   ([dense], None, (True,)),
                                   ([dense, ids], "int8", (True,))):
        with pytest.raises(ValueError, match="quantized"):
            tp.pack_send_all(assign, payloads, 2, 2, codec=codec,
                             quantized=marks)
