"""Remat on the CPU, against the JAX package's and against no remat.

- ``launch.steps.make_train_step(remat=True)`` against the reference's
  ``make_train_step(remat=True)``, unsharded and jitted, 3 Adam steps
  (lr 1e-2) at every family's smoke config (dense, MoE, SSM, hybrid,
  VLM, audio; the MoE at ``MOE_BLOCKS`` 2 and 4 in
  ``test_torch_moe_blocks.py``):
  losses within the slice tests' 5e-5 (MoE 1e-4, as its driver test).
  The LM families train on the slice tests' token stream, B 2 x S 256:
  on ``make_train_batch``'s draws at S 64 a rounding difference flips a
  routing or the sign of Adam's step on a near-zero gradient, and
  phi3.5-moe's and a 5-layer recurrentgemma's losses part by ~4e-4 in
  both packages' remat=False steps alike (llama4-scout's top-1 router
  does so at S 512 too; its blocks are held layer by layer in
  ``test_torch_moe_blocks.py``);
- remat against no remat in the port, bit for bit on one thread
  (losses and every parameter after 3 steps; recurrentgemma at 5
  layers, a group of 3 and 2 rest), and the forward twice under remat:
  B8's and the scan's wrappers run twice a checkpointed layer and step,
  once a ``rest`` layer, once under ``no_grad``.

The reference's weights come across through ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import token_stream as jtokens
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import linear_scan as LS
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api, backbone, whisper
from repro_torch.optim import get_optimizer

STEPS, LR = 3, 1e-2
LOSS_TOL, MOE_TOL, TOL = 5e-5, 1e-4, 1e-5
PHI = "phi3.5-moe-42b-a6.6b"
# family cases: arch -> (B, S, n_layers override or None, batches from
# the token stream of the slice tests rather than make_train_batch)
CASES = {
    "smollm-360m": (2, 256, None, True),
    PHI: (2, 256, None, True),
    "falcon-mamba-7b": (2, 256, None, True),
    "recurrentgemma-2b": (2, 256, None, True),
    "pixtral-12b": (2, 64, None, False),       # 16 patches + 48 tokens
    "whisper-large-v3": (2, 64, None, False),
}
# remat's grouping with rest layers (recurrentgemma at 5 layers: a group
# of 3, then 2 unchecked), held bit for bit below
REST_LAYERS = {"recurrentgemma-2b": 5}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, n_layers=None):
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _port_model(cfg, tree):
    tree = jax.tree.map(np.asarray, tree)
    if cfg.family == "audio":
        return whisper.params_from_jax(tree, cfg)
    return backbone.params_from_jax(tree, cfg)


@pytest.fixture(autouse=True)
def one_thread():
    """Every test on one PyTorch thread: the bit-for-bit comparison
    needs it, and with several test workers sharing the CPU the ops'
    own thread pools would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, B, S, stream=False, seed=1):
    """``STEPS`` batches: ``make_train_batch``'s draws from one rng, or
    the slice tests' ``token_stream(0)`` shifted into tokens and
    labels."""
    if stream:
        it = jtokens(0, cfg.vocab, B, S + 1)
        return [{"tokens": t[:, :-1], "labels": t[:, 1:]}
                for t in (next(it) for _ in range(STEPS))]
    rng = np.random.default_rng(seed)
    return [api.make_train_batch(rng, cfg, B, S) for _ in range(STEPS)]


def _reference_steps(jcfg, params, batches):
    opt = jopt.adam(LR)
    step = jax.jit(jsteps.make_train_step(jcfg, opt, remat=True))
    o, losses = opt.init(params), []
    for batch in batches:
        params, o, loss = step(params, o, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
        losses.append(float(loss))
    return losses


# --------------------------------------------------------------------------
# the remat train step against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(CASES))
def test_remat_train_steps_match_reference(arch):
    assert_remat_steps_match_reference(arch)


def assert_remat_steps_match_reference(arch):
    """3 remat steps of ``arch`` (at the knobs the caller set) against
    the reference's."""
    B, S, n_layers, stream = CASES[arch]
    jcfg, cfg = _cfgs(arch, n_layers)
    params = japi.init_model(jax.random.key(0), jcfg)
    batches = _batches(cfg, B, S, stream)
    want = _reference_steps(jcfg, params, batches)
    model = _port_model(cfg, params)
    step = make_train_step(cfg, model, get_optimizer("adam", LR), remat=True)
    got = [float(step({k: _t(v) for k, v in b.items()})) for b in batches]
    tol = MOE_TOL if cfg.mlp == "moe" else LOSS_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert all(np.isfinite(got))


# --------------------------------------------------------------------------
# remat against no remat in the port
# --------------------------------------------------------------------------
def _port_run(cfg, batch, remat, seed=0):
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    step = make_train_step(cfg, model, get_optimizer("adam", LR),
                           remat=remat)
    losses = [step(batch) for _ in range(STEPS)]
    return losses, [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("arch", list(CASES) + ["llama4-scout-17b-a16e"])
def test_remat_is_bit_for_bit_no_remat(arch):
    _, cfg = _cfgs(arch, REST_LAYERS.get(arch))
    B, S = 2, 128
    batch = {k: _t(v) for k, v in api.make_train_batch(
        np.random.default_rng(2), cfg, B, S).items()}
    l1, p1 = _port_run(cfg, batch, True)
    l0, p0 = _port_run(cfg, batch, False)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1)), (l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of B8's and the scan's wrappers, forward and
    backward (where the card counts their launches; on the CPU they run
    the plain versions)."""
    calls = {"b8": 0, "b8_bwd": 0, "scan": 0, "scan_bwd": 0}

    def counted(mod, name, key):
        plain = getattr(mod, name)

        def f(*a, **kw):
            calls[key] += 1
            return plain(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    counted(FA, "flash_attention", "b8")
    counted(FA, "flash_attention_backward", "b8_bwd")
    counted(LS, "linear_scan", "scan")
    counted(LS, "linear_scan_backward", "scan_bwd")
    return calls


@pytest.mark.parametrize("remat", [True, False])
def test_remat_runs_the_forward_twice_a_checkpointed_layer(remat,
                                                           plain_calls):
    """smollm's smoke config at S 2,048 (B8's route) and falcon-mamba's
    (the scan): a step runs B8's or the scan's forward twice a layer
    with remat (the recompute), once without; the backward once a
    layer either way; recurrentgemma at 5 layers runs its 2 rest
    layers' scan once."""
    for arch, B, S, n_layers, fwd, bwd in (
            ("smollm-360m", 1, 2048, None, "b8", "b8_bwd"),
            ("falcon-mamba-7b", 1, 64, None, "scan", "scan_bwd"),
            ("recurrentgemma-2b", 1, 64, 5, "scan", "scan_bwd")):
        _, cfg = _cfgs(arch, n_layers)
        model = api.init_model(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        batch = {k: _t(v) for k, v in api.make_train_batch(
            np.random.default_rng(0), cfg, B, S).items()}
        step = make_train_step(cfg, model, get_optimizer("adam", LR),
                               remat=remat)
        n_groups, gkinds, rkinds = backbone.group_layout(cfg)
        kind = "full" if fwd == "b8" else ("mamba" if cfg.family == "ssm"
                                           else "rglru")
        grouped = n_groups * sum(k == kind for k in gkinds)
        rest = sum(k == kind for k in rkinds)
        for k in plain_calls:
            plain_calls[k] = 0
        step(batch)
        assert plain_calls[fwd] == (2 if remat else 1) * grouped + rest, arch
        assert plain_calls[bwd] == grouped + rest, arch
        plain_calls[fwd] = 0
        with torch.no_grad():
            api.train_loss(model, cfg, batch, remat=remat)
        assert plain_calls[fwd] == grouped + rest


