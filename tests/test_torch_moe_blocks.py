"""``MOE_BLOCKS``, the MoE's block dispatch, on the CPU against the JAX
package's (``dist.ctx.MOE_BLOCKS``, ``models/layers.py::moe_ffn``).

- 3 remat steps of phi3.5-moe's smoke config at ``MOE_BLOCKS`` 2 and 4
  against the reference's jitted ``make_train_step(remat=True)``, as
  ``test_torch_remat.py`` holds it at 1 (losses within 1e-4);
- phi3.5-moe's smoke loss at ``MOE_BLOCKS`` 1, 2 and 4 on
  ``default_rng(0)``'s 2 x 64 batch and ``init_model(key(0))``, both
  packages within 1e-5 of 7.535805, 7.527155 and 7.507915;
- ``moe_ffn`` block by block against the reference's (1e-5): each
  block dispatched with its own capacity, the one-block path where the
  blocks do not divide the tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist import ctx as jctx
from repro.models import api as japi
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.dist import ctx
from repro_torch.models import api
from repro_torch.models import layers as tl
from test_torch_remat import (PHI, TOL, _cfgs, _port_model, _t,
                              assert_remat_steps_match_reference,
                              one_thread)

# phi3.5-moe smoke, the reference's api.train_loss on default_rng(0)'s
# 2 x 64 batch and init_model(key(0)), by MOE_BLOCKS
MOE_LOSSES = {1: 7.535805, 2: 7.527155, 4: 7.507915}


@pytest.fixture
def moe_blocks():
    """Sets both packages' MOE_BLOCKS; restores 1 after."""
    def put(nb):
        ctx.MOE_BLOCKS = jctx.MOE_BLOCKS = nb
    yield put
    put(1)


@pytest.mark.parametrize("nb", [2, 4])
def test_remat_train_steps_match_reference(nb, moe_blocks):
    moe_blocks(nb)
    assert_remat_steps_match_reference(PHI)


@pytest.mark.parametrize("nb", [1, 2, 4])
def test_moe_block_losses_match_the_reference_values(nb, moe_blocks):
    jcfg, cfg = _cfgs(PHI)
    moe_blocks(nb)
    params = japi.init_model(jax.random.key(0), jcfg)
    batch = api.make_train_batch(np.random.default_rng(0), cfg, 2, 64)
    want = float(japi.train_loss(params, jcfg, {k: jnp.asarray(v) for k, v
                                                in batch.items()}))
    with torch.no_grad():
        got = float(api.train_loss(_port_model(cfg, params), cfg,
                                   {k: _t(v) for k, v in batch.items()}))
    assert abs(want - MOE_LOSSES[nb]) < 1e-5
    assert abs(got - MOE_LOSSES[nb]) < 1e-5


@pytest.mark.parametrize("arch,nb,S", [(PHI, 2, 16), (PHI, 4, 15),
                                       ("llama4-scout-17b-a16e", 4, 16)])
def test_moe_ffn_blocks_match_reference(arch, nb, S, moe_blocks):
    """Each block dispatched with its own capacity (phi3.5-moe top-2,
    llama4-scout top-1 with its shared expert); at T = 30 four blocks do
    not divide and the one-block path runs."""
    cfg = jget(arch, smoke=True)
    p = jax.tree.map(np.array, jl.init_moe(jax.random.key(3), cfg,
                                           jnp.float32))
    shared = p.get("shared")
    mod = tl.MoE(_t(p["router"]["w"]), _t(p["wi"]), _t(p["wg"]), _t(p["wo"]),
                 None if shared is None else tl.MLP(
                     _t(shared["wi"]["w"]), _t(shared["wo"]["w"]),
                     _t(shared["wg"]["w"])))
    x = np.random.default_rng(4).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    moe_blocks(nb)
    want, want_aux = jax.jit(jl.moe_ffn, static_argnums=2)(
        p, jnp.asarray(x), cfg)
    got, aux = tl.moe_ffn(mod, _t(x), get_config(arch, smoke=True))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    assert abs(aux.item() - float(want_aux)) < TOL
