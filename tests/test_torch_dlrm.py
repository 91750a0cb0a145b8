"""repro_torch.models.dlrm against the JAX package's DLRM forward.

The JAX weights move into the port with ``params_from_jax``.  Both sides
compute in f32 with matrix products and sums taken in another order, so
logits match within rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DLRM_CONFIGS as J_CONFIGS
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.models import dlrm as jdlrm
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.models import dlrm as tdlrm

ARCHS = ["wdl-tiny", "dfm-tiny", "dcn-tiny"]


def _np_params(arch, seed=0):
    cfg = J_CONFIGS[arch]
    p = jdlrm.init_params(jax.random.key(seed), cfg, J_WORKLOADS[cfg.workload])
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("inject", [False, True], ids=["gather", "emb_all"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, inject):
    cfg = DLRM_CONFIGS[arch]
    wl = WORKLOADS[cfg.workload]
    params = _np_params(arch)
    model = tdlrm.params_from_jax(params, cfg)
    rng = np.random.default_rng(3)
    sparse = wl.sample_batch(rng, 6)
    dense = wl.dense_batch(rng, 6)
    emb = None
    if inject:
        emb = (rng.normal(size=(6, wl.width, cfg.embedding_dim))
               * (sparse >= 0)[..., None]).astype(np.float32)
    want = np.asarray(jdlrm.forward(
        params, J_CONFIGS[arch], jnp.asarray(sparse), jnp.asarray(dense),
        n_fields=wl.n_fields,
        emb_all=None if emb is None else jnp.asarray(emb)))
    got = model(torch.from_numpy(sparse), torch.from_numpy(dense),
                n_fields=wl.n_fields,
                emb_all=None if emb is None else torch.from_numpy(emb))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scales_match_jax(arch):
    cfg = DLRM_CONFIGS[arch]
    wl = WORKLOADS[cfg.workload]
    ref = _np_params(arch)
    model = tdlrm.init_params(cfg, wl, torch.Generator().manual_seed(0),
                              "cpu")
    assert model.embed.shape == ref["embed"].shape
    assert [tuple(w.shape) for w in model.bottom] == \
        [lp["w"].shape for lp in ref["bottom"]]
    assert [tuple(w.shape) for w in model.top] == \
        [lp["w"].shape for lp in ref["top"]]
    for name in ("wide", "cross_w", "cross_b"):
        assert (getattr(model, name) is None) == (name not in ref)
        if name in ref:
            assert tuple(getattr(model, name).shape) == ref[name].shape
    # same distributions: N(0, 0.01) tables, din**-0.5 MLP scale
    assert abs(float(model.embed.std()) - 0.01) < 1e-3
    w0 = model.bottom[0]
    assert abs(float(w0.std()) - w0.shape[0] ** -0.5) < 0.1 * w0.shape[0] ** -0.5
    if cfg.kind == "dcn":
        assert float(model.cross_b.abs().max()) == 0.0


def test_model_rejects_missing_interaction_weights():
    params = _np_params("wdl-tiny")
    del params["wide"]
    with pytest.raises(ValueError, match="wide"):
        tdlrm.params_from_jax(params, DLRM_CONFIGS["wdl-tiny"])
