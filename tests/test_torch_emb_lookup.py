"""repro_torch.kernels.emb_lookup against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU; the port's wrappers,
given CPU tensors, run their plain PyTorch versions.  Inputs come from a
numpy seed and go to both.

Tolerances:
  * staged_gather selects and copies rows, no arithmetic: exact.
  * pooled_lookup_staged sums F weighted rows in f32 in the same order on
    both sides; the only difference left is whether ``w * row + acc`` is
    contracted into one FMA, so rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import emb_lookup as jk
from repro_torch.kernels import emb_lookup as tk


def _inputs(seed, V, C, E, B, F):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, E)).astype(np.float32)
    plane = rng.normal(size=(C, E)).astype(np.float32)
    src = rng.integers(-1, V, C).astype(np.int32)
    src[rng.random(C) < 0.3] = -1
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.3] = -1
    slots = rng.integers(-1, C, (B, F)).astype(np.int32)
    slots[ids < 0] = -1
    w = rng.random((B, F)).astype(np.float32)
    return table, plane, src, ids, slots, w


@pytest.mark.parametrize("E", [16, 22, 130])
def test_staged_gather_matches_jax_exactly(E):
    table, plane, src, *_ = _inputs(0, V=40, C=12, E=E, B=1, F=1)
    want = np.asarray(jk.staged_gather(jnp.asarray(plane), jnp.asarray(table),
                                       jnp.asarray(src), interpret=True))
    got = tk.staged_gather_ref(torch.from_numpy(plane),
                               torch.from_numpy(table), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version
    got_w = tk.staged_gather(torch.from_numpy(plane), torch.from_numpy(table),
                             torch.from_numpy(src))
    np.testing.assert_array_equal(got_w.numpy(), want)


@pytest.mark.parametrize("B,E,weighted", [(1, 16, False), (5, 22, False),
                                          (4, 130, True)])
def test_pooled_lookup_staged_matches_jax(B, E, weighted):
    table, plane, _, ids, slots, w = _inputs(1, V=50, C=8, E=E, B=B, F=7)
    wj = jnp.asarray(w) if weighted else None
    wt = torch.from_numpy(w) if weighted else None
    want = np.asarray(jk.pooled_lookup_staged(
        jnp.asarray(plane), jnp.asarray(table), jnp.asarray(slots),
        jnp.asarray(ids), wj, interpret=True))
    args = (torch.from_numpy(plane), torch.from_numpy(table),
            torch.from_numpy(slots), torch.from_numpy(ids), wt)
    got = tk.pooled_lookup_staged_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    before = dict(tk.LAUNCHES)
    np.testing.assert_array_equal(tk.pooled_lookup_staged(*args).numpy(),
                                  got.numpy())
    assert tk.LAUNCHES == before   # no kernel launch on the CPU


def test_wrappers_reject_what_the_kernels_do_not_take():
    table, plane, src, ids, slots, w = _inputs(2, V=20, C=6, E=8, B=3, F=4)
    P, T = torch.from_numpy(plane), torch.from_numpy(table)
    S, I, L = (torch.from_numpy(src), torch.from_numpy(ids),
               torch.from_numpy(slots))
    with pytest.raises(TypeError, match="int32"):
        tk.staged_gather(P, T, S.long())
    with pytest.raises(ValueError, match="contiguous"):
        tk.staged_gather(torch.from_numpy(np.asfortranarray(plane)), T, S)
    with pytest.raises(ValueError, match="shape"):
        tk.staged_gather(P, T, S[:-1])
    with pytest.raises(TypeError, match="float32"):
        tk.staged_gather(P.double(), T, S)
    with pytest.raises(TypeError, match="int32"):
        tk.pooled_lookup_staged(P, T, L, I.long())
    with pytest.raises(ValueError, match="contiguous"):
        tk.pooled_lookup_staged(P, T, L.t().contiguous().t(), I)
    with pytest.raises(ValueError, match="shape"):
        tk.pooled_lookup_staged(P, T, L[:, :-1].contiguous(), I)
    with pytest.raises(TypeError, match="float32"):
        tk.pooled_lookup_staged(P, T, L, I, torch.from_numpy(w).double())
