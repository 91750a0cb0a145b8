"""The LM training slice as a whole: repro_torch against the JAX package.

The JAX package's LM driver fails on this tree (ROADMAP C-ref-4: its
sharded embedding gather raises ``ShardingTypeError``), so the reference
side is its unsharded step, as its driver builds it: ``jax.value_and_grad
(api.train_loss, remat=False)`` and ``adam(lr)`` under ``jax.jit``, over
``token_stream(seed, vocab, B, S + 1)`` (inputs ``[:, :-1]``, labels
``[:, 1:]``).  At S = 2048 every layer's attention takes the flash route
(the reference's jnp scan; the port's B8 through its plain version and
blockwise backward).  The port runs its driver ``run_lm`` (``--arch
smollm-360m --smoke --seq-len 2048 --device cpu``, B = 2) from the
reference's initial weights carried across with ``params_from_jax``.

Step 0's gradients agree leaf by leaf within 5e-6 absolute (the largest
is ~1; f32 sums over 4,096 tokens and 2,048 keys in another order), and
the driver's losses of all 3 steps within 5e-5 (Adam at lr 1e-2 turns a
rounding difference of a gradient near 0 into a step of up to lr; the
measured gap is under 1e-5).

In bf16 (the full-width models' dtype) at S = 128, the naive route on
both sides, 3 driver steps and 8 decode steps are held to 2e-2: bf16
keeps 8 significant bits (an ulp of 2**-7 at 1), XLA fuses elementwise
chains and rounds once where PyTorch rounds after each operation, so
activations differ by an ulp here and there, and logits up to ~1.5 by
one or two ulps (<= 1.6e-2); the f32 loss of ~7 averages such
differences over 256 tokens, and Adam at lr 1e-2 turns gradient
differences near 0 into steps of up to lr.  (At S >= 2,048 B8 would add
its own: it keeps its accumulator in f32 where the reference's scan
keeps q's dtype.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import token_stream as jtokens
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as tf
from repro_torch.launch.train import build_parser, run_lm
from repro_torch.models import api, backbone

ARCH, S, B, STEPS, SEED, LR = "smollm-360m", 2048, 2, 3, 0, 1e-2
GRAD_TOL, LOSS_TOL = 5e-6, 5e-5


@pytest.fixture(scope="module")
def reference():
    cfg = jget(ARCH, smoke=True)
    params = japi.init_model(jax.random.key(SEED), cfg)
    tree = jax.tree.map(np.asarray, params)
    opt = jopt.adam(LR)

    @jax.jit
    def step(p, o, tokens, labels):
        loss, g = jax.value_and_grad(japi.train_loss)(
            p, cfg, {"tokens": tokens, "labels": labels}, remat=False)
        p, o = opt.update(g, o, p)
        return p, o, loss, g

    stream = jtokens(SEED, cfg.vocab, B, S + 1)
    p, o, losses = params, opt.init(params), []
    for i in range(STEPS):
        tok = next(stream)
        p, o, loss, g = step(p, o, jnp.asarray(tok[:, :-1]),
                             jnp.asarray(tok[:, 1:]))
        losses.append(float(loss))
        if i == 0:
            grads0 = jax.tree.map(np.asarray, g)
    return tree, grads0, losses


def _leaf(tree, name: str, pattern_len: int):
    """The reference leaf of the port's parameter ``name``: layer j is
    ``groups/l{j % P}`` at index ``j // P``; a linear's weight sits
    under ``w``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    j, path = int(parts[1]), parts[2:]
    node = tree["groups"][f"l{j % pattern_len}"]
    for part in path:
        node = node[part]
    if path[0] == "ffn":
        node = node["w"]
    return node[j // pattern_len]


def test_step0_gradients_match_leaf_by_leaf(reference):
    tree, grads0, _ = reference
    cfg = get_config(ARCH, smoke=True)
    model = backbone.params_from_jax(tree, cfg)
    tok = torch.as_tensor(next(jtokens(SEED, cfg.vocab, B, S + 1)))
    loss = api.train_loss(model, cfg, {"tokens": tok[:, :-1],
                                       "labels": tok[:, 1:]})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(names) == 2 + 9 * cfg.n_layers    # embed, final_norm; 9 a layer
    for name, g in zip(names, grads):
        np.testing.assert_allclose(
            g.numpy(), _leaf(grads0, name, len(cfg.layer_pattern)), rtol=0,
            atol=GRAD_TOL, err_msg=name)


def test_driver_losses_match_the_reference_step(reference):
    tree, _, want = reference
    cfg = get_config(ARCH, smoke=True)
    args = build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--seq-len", str(S), "--batch-per-worker",
         str(B), "--steps", str(STEPS), "--seed", str(SEED), "--lr", str(LR),
         "--device", "cpu"])
    n0 = tf.LAUNCHES["flash_attention"]
    out = run_lm(args, model=backbone.params_from_jax(tree, cfg))
    assert tf.LAUNCHES["flash_attention"] == n0     # CPU: no kernel launch
    assert out["steps"] == STEPS and out["batch"] == B
    assert out["seq_len"] == S and out["device"] == "cpu"
    got = [r["loss"] for r in out["metrics"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert got[-1] < got[0]


BF16_TOL = 2e-2


def test_bf16_steps_match_the_reference_step():
    """3 driver steps of smollm-360m smoke in bf16 at S = 128, B = 2
    against the reference's unsharded step, losses within 2e-2."""
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    params = japi.init_model(jax.random.key(SEED), jcfg)
    tree = jax.tree.map(np.asarray, params)
    opt = jopt.adam(LR)

    @jax.jit
    def step(p, o, tokens, labels):
        loss, g = jax.value_and_grad(japi.train_loss)(
            p, jcfg, {"tokens": tokens, "labels": labels}, remat=False)
        p, o = opt.update(g, o, p)
        return p, o, loss

    stream = jtokens(SEED, jcfg.vocab, B, 128 + 1)
    p, o, want = params, opt.init(params), []
    for _ in range(STEPS):
        tok = next(stream)
        p, o, loss = step(p, o, jnp.asarray(tok[:, :-1]),
                          jnp.asarray(tok[:, 1:]))
        want.append(float(loss))
    args = build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--seq-len", "128", "--batch-per-worker",
         str(B), "--steps", str(STEPS), "--seed", str(SEED), "--lr", str(LR),
         "--device", "cpu"])
    model = backbone.params_from_jax(tree, cfg)
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    out = run_lm(args, model=model, cfg=cfg)
    got = [r["loss"] for r in out["metrics"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_bf16_decode_matches_the_reference():
    """8 bf16 decode steps of smollm-360m smoke against the reference's
    ``decode_step`` under ``jax.jit``: logits within 2e-2."""
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    params = japi.init_model(jax.random.key(1), jcfg)
    model = backbone.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab,
                                             (2, 8)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: japi.decode_step(p, jcfg, t, c, pos))
    jcache = japi.init_decode_cache(jcfg, 2, 8)
    cache = api.init_decode_cache(cfg, 2, 8, "cpu")
    for pos in range(8):
        want, jcache = jstep(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jcache, jnp.asarray(pos, jnp.int32))
        got, cache = api.decode_step(model, cfg,
                                     torch.as_tensor(toks[:, pos:pos + 1]),
                                     cache, pos)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=0, atol=BF16_TOL, err_msg=str(pos))
