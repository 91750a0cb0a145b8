"""Kernel B1 (pooled lookup) and the Alg. 1 built on it: repro_torch
against the JAX package on the CPU.

The port's wrapper runs its plain version on CPU tensors; the reference
runs its Pallas kernel in interpret mode.  Both sum over f = 0..F-1 in
order.  The port rounds each product before its add (so does its CUDA
kernel); XLA's CPU interpreter fuses the two into one FMA.  Where every
product is exact (weights that are 0 or powers of two, as Alg. 1's 0/1
dedup weights are) the two must agree bit for bit; with arbitrary
weights they differ by the product's rounding, held to rtol = 1e-6.  The
kernel-backed touched-ids Alg. 1 of the two packages must agree bit for
bit.  The reference's second formula (``cost_matrix_sparse_jnp``) sums
the slots in another order and is held to rtol = 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost import cost_matrix_sparse_jnp
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.kernels.emb_lookup import pooled_lookup as j_pooled_lookup
from repro.kernels.ops import cost_matrix_pallas_sparse
from repro_torch.core.cost import cost_matrix_sparse, dedup_mask
from repro_torch.kernels import emb_lookup as tk
from repro_torch.kernels.ops import cost_matrix_sparse_kernel


def _bags(rng, V, B, F):
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.3] = -1
    # 0 and powers of two: every product is exact
    w = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0, 2.0]), (B, F))
    return ids, w.astype(np.float32)


def _both(table, ids, weights):
    want = np.asarray(j_pooled_lookup(
        jnp.asarray(table), jnp.asarray(ids),
        None if weights is None else jnp.asarray(weights), interpret=True))
    got = tk.pooled_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                           None if weights is None
                           else torch.from_numpy(weights))
    return got.numpy(), want


@pytest.mark.parametrize("E", [4, 16, 130])
def test_pooled_lookup_ref_matches_pallas_interpret(E):
    rng = np.random.default_rng(E)
    table = rng.normal(size=(50, E)).astype(np.float32)
    ids, w = _bags(rng, 50, 6, 11)
    n0 = tk.LAUNCHES["pooled_lookup"]
    for weights in (w, None):
        got, want = _both(table, ids, weights)
        np.testing.assert_array_equal(got, want)
    assert tk.LAUNCHES["pooled_lookup"] == n0   # CPU: no kernel launched


def test_pooled_lookup_ref_arbitrary_weights():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    ids, _ = _bags(rng, 40, 5, 9)
    w = rng.random(ids.shape).astype(np.float32)
    got, want = _both(table, ids, w)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _state(rng, n, V):
    latest = rng.random((n, V)) < 0.4
    dirty = latest & (rng.random((n, V)) < 0.5)
    return latest, dirty


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_matrix_matches_reference(seed):
    rng = np.random.default_rng(seed)
    wl = J_WORKLOADS["tiny"]
    n, k = 4, 8
    samples = wl.sample_batch(rng, k).astype(np.int32)
    latest, dirty = _state(rng, n, wl.vocab)
    t = (np.linspace(1.0, 4.0, n) * 1e-4).astype(np.float32)
    j_args = tuple(map(jnp.asarray, (samples, latest, dirty, t)))
    t_args = tuple(map(torch.from_numpy, (samples, latest, dirty, t)))
    got = cost_matrix_sparse_kernel(*t_args).numpy()
    # the kernel route of both packages: bit for bit
    want = np.asarray(cost_matrix_pallas_sparse(*j_args, interpret=True))
    np.testing.assert_array_equal(got, want)
    # the reference's jnp formula sums the slots in another order
    jnp_c = np.asarray(cost_matrix_sparse_jnp(*j_args))
    np.testing.assert_allclose(got, jnp_c, rtol=1e-6, atol=0)
    np.testing.assert_allclose(cost_matrix_sparse(*t_args).numpy(), jnp_c,
                               rtol=1e-6, atol=0)


def test_dedup_mask_keeps_first_occurrence():
    s = torch.tensor([[3, -1, 0, 3, 0, -1]], dtype=torch.int32)
    ids, mask = dedup_mask(s)
    assert ids.tolist() == [[3, 0, 0, 3, 0, 0]]
    assert mask.tolist() == [[True, False, True, False, False, False]]
