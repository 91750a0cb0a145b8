"""The VLM prefix (pixtral-12b's smoke config) on the CPU: repro_torch
against the JAX package.

pixtral's decoder is the dense backbone; its stub patch embeddings
(B, P, D) are fused in front of the token embeddings, positions run 0 ..
P+S-1, and the loss slices the logits' first P off.  The reference's
``init_params`` is carried across with ``backbone.params_from_jax``;
batches are ``api.make_train_batch``'s, drawn from one numpy seed in
each package.  Held against the reference:

- ``make_train_batch``'s draws, bit for bit;
- ``forward`` and ``lm_loss`` with a prefix at P+S = 128 (the naive
  route) and at P+S = 2,048 (16 patches + 2,032 tokens: the flash route,
  the port's B8 plain version against the reference's jnp
  ``attention_flash``; P+S, not S, decides the route);
- step 0's gradients against ``jax.grad``, 3 steps of
  ``make_train_step`` against the reference's unsharded jitted
  ``value_and_grad(api.train_loss, remat=False)`` and ``adam`` (its LM
  driver fails: ROADMAP C-ref-4), and ``make_prefill_step``'s unsliced
  logits, all at P+S = 2,048;
- a bf16 loss with f32 patches (the prefix cast to bf16).

Tolerances: f32 logits within 1e-5 absolute at P+S = 128 and 3e-5 at
2,048 (the dense prefill test's: the online softmax over 4 key blocks
in another order); losses within 1e-5; gradients within 1e-5 of each
leaf's largest; the 3 steps' losses within 5e-5 (Adam at lr 1e-2 turns
a rounding difference of a gradient near 0 into a step of up to lr);
the bf16 loss within 2e-2, the bf16 LM slice's tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import backbone as jbb
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import api, backbone
from repro_torch.models.tree import from_ref
from repro_torch.optim import get_optimizer

ARCH = "pixtral-12b"
TOL, GRAD_TOL, LOSS_TOL, BF16_TOL = 1e-5, 1e-5, 5e-5, 2e-2
STEPS, LR = 3, 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(seed=0, **over):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), **over)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    params = japi.init_model(jax.random.key(seed), jcfg)
    model = backbone.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


def _batch(cfg, seed, B, S):
    return api.make_train_batch(np.random.default_rng(seed), cfg, B, S)


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture
def b8_calls(monkeypatch):
    """Counts the calls of B8's plain version (the CPU's route through
    ``flash_attention``) and B8's launches, which stay 0 on the CPU."""
    calls = {"ref": 0}
    plain = FA.flash_attention_ref

    def counted(*a, **kw):
        calls["ref"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(FA, "flash_attention_ref", counted)
    n0 = dict(FA.LAUNCHES)
    yield calls
    assert FA.LAUNCHES == n0


@pytest.mark.parametrize("S", [128, 2048])
def test_make_train_batch_draws_equal(S):
    """S - P tokens and labels and the (B, P, D) patches, bit for bit."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget(ARCH, smoke=True)
    got = api.make_train_batch(np.random.default_rng(3), cfg, 2, S)
    want = japi.make_train_batch(np.random.default_rng(3), jcfg, 2, S)
    assert set(got) == set(want) == {"tokens", "labels", "patches"}
    assert got["tokens"].shape == (2, S - cfg.n_patches)
    assert got["patches"].shape == (2, cfg.n_patches, cfg.d_model)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("B,S,flash", [(2, 128, False), (1, 2048, True)])
def test_forward_and_loss_with_a_prefix_match_reference(B, S, flash,
                                                        b8_calls):
    """The logits over all P+S positions and the loss over the text's S-P
    (labels with pads); at P+S = 2,048 each layer's attention runs B8's
    plain version (S - P = 2,032 tokens alone would take the naive
    route)."""
    jcfg, params, cfg, model = _models(seed=1)
    b = _batch(cfg, 2, B, S)
    b["labels"][:, :3] = -1
    want, _ = jax.jit(lambda p, t, x: jbb.forward(
        p, jcfg, t, prefix_embeds=x, remat=False))(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["patches"]))
    want_loss = japi.train_loss(params, jcfg, _jb(b), remat=False)
    with torch.no_grad():
        got, aux = backbone.forward(model, cfg, _t(b["tokens"]),
                                    prefix_embeds=_t(b["patches"]))
        loss = api.train_loss(model, cfg, _tb(b))
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    assert b8_calls["ref"] == (2 * cfg.n_layers if flash else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5 if flash else TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=TOL)


def test_prefix_moves_the_text_logits():
    """The prefix is attended: the text positions' logits differ from a
    forward of the tokens alone, whose positions start at 0."""
    _, _, cfg, model = _models(seed=3)
    b = _batch(cfg, 4, 1, 64)
    with torch.no_grad():
        with_prefix, _ = backbone.forward(model, cfg, _t(b["tokens"]),
                                          prefix_embeds=_t(b["patches"]))
        alone, _ = backbone.forward(model, cfg, _t(b["tokens"]))
    assert with_prefix.shape[1] == alone.shape[1] + cfg.n_patches
    assert float((with_prefix[:, cfg.n_patches:] - alone).abs().max()) > 1e-2


_REFERENCE: dict = {}


def _reference():
    """The reference's unsharded jitted step, 3 steps at B 1, P+S = 2,048
    on one batch: (initial tree, step 0's gradients, losses)."""
    if not _REFERENCE:
        cfg = jget(ARCH, smoke=True)
        params = japi.init_model(jax.random.key(0), cfg)
        opt = jopt.adam(LR)
        batch = _jb(_batch(cfg, 5, 1, 2048))

        @jax.jit
        def step(p, o):
            loss, g = jax.value_and_grad(japi.train_loss)(p, cfg, batch,
                                                          remat=False)
            p, o = opt.update(g, o, p)
            return p, o, loss, g

        p, o, losses = params, opt.init(params), []
        for i in range(STEPS):
            p, o, loss, g = step(p, o)
            losses.append(float(loss))
            if i == 0:
                grads0 = jax.tree.map(np.asarray, g)
        _REFERENCE.update(tree=jax.tree.map(np.asarray, params),
                          grads0=grads0, losses=losses)
    return _REFERENCE


def test_step0_gradients_match_leaf_by_leaf(b8_calls):
    """At P+S = 2,048: B8's plain backward in every layer against
    ``jax.grad`` through the reference's jnp ``attention_flash``."""
    ref = _reference()
    cfg = get_config(ARCH, smoke=True)
    model = backbone.params_from_jax(ref["tree"], cfg)
    loss = api.train_loss(model, cfg, _tb(_batch(cfg, 5, 1, 2048)),
                          remat=False)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    want = from_ref(ref["grads0"], backbone.ref_paths(model, cfg))
    assert b8_calls["ref"] == cfg.n_layers
    for name, g, w in zip(names, grads, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_train_steps_match_the_reference_step():
    """3 steps of ``make_train_step`` (Adam, lr 1e-2) at B 1, 16 patches
    + 2,032 tokens: the losses within 5e-5, falling."""
    ref = _reference()
    cfg = get_config(ARCH, smoke=True)
    model = backbone.params_from_jax(ref["tree"], cfg)
    step = make_train_step(cfg, model, get_optimizer("adam", LR),
                           remat=False)
    batch = _tb(_batch(cfg, 5, 1, 2048))
    got = [float(step(batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, ref["losses"], rtol=0, atol=LOSS_TOL)
    assert got[-1] < got[0]


def test_prefill_matches_reference(b8_calls):
    """``make_prefill_step`` with ``patches``: the logits over all P+S =
    2,048 positions, unsliced, as the reference returns them; without
    ``patches`` it is the text-only forward."""
    jcfg, params, cfg, model = _models(seed=7)
    b = _batch(cfg, 8, 1, 2048)
    want = jax.jit(jsteps.make_prefill_step(jcfg, remat=False))(params,
                                                                _jb(b))
    got = make_prefill_step(cfg)(model, _tb(b))
    assert not got.requires_grad and got.shape == (1, 2048, cfg.vocab)
    assert b8_calls["ref"] == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)
    text = make_prefill_step(cfg)(model, {"tokens": _t(b["tokens"][:, :64])})
    assert text.shape == (1, 64, cfg.vocab)


def test_bf16_loss_casts_the_prefix():
    """In bf16 the f32 patches are cast to the embeddings' dtype (the
    logits come out bf16), and the loss at P+S = 128 is within 2e-2 of
    the reference's bf16 loss."""
    jcfg, params, cfg, model = _models(seed=9, dtype="bfloat16")
    b = _batch(cfg, 10, 2, 128)
    assert b["patches"].dtype == np.float32
    want = japi.train_loss(params, jcfg, _jb(b), remat=False)
    with torch.no_grad():
        logits, _ = backbone.forward(model, cfg, _t(b["tokens"]),
                                     prefix_embeds=_t(b["patches"]))
        got = api.train_loss(model, cfg, _tb(b))
    assert logits.dtype == torch.bfloat16
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=0,
                               atol=BF16_TOL)
