"""The SSM and hybrid LMs as a whole: repro_torch against the JAX package.

falcon-mamba-7b (every layer a Mamba block, no FFN) and
recurrentgemma-2b (RG-LRU, RG-LRU, local attention, cycled; window 64
at the smoke widths) in their smoke configs, f32, with the reference's
``init_params`` carried across by ``params_from_jax``:

- ``forward`` and ``lm_loss`` (recurrentgemma also at S 2,048, where its
  local layers take the blockwise route and the window of 64 masks most
  of each block);
- step 0's gradients leaf by leaf, and 3 steps of the port's driver
  ``run_lm`` against the reference's unsharded step (its LM driver fails
  with ROADMAP C-ref-4): ``jax.value_and_grad(api.train_loss,
  remat=False)`` and ``adam`` under ``jax.jit`` over the same
  ``token_stream``; falcon-mamba at S 512 (two scan chunks of 256),
  recurrentgemma at S 2,048;
- 8 decode steps against the reference's ``decode_step`` under
  ``jax.jit`` (each layer's state, conv window and KV ring equal), and
  the port's decode against its own prefill;
- the blockwise ``attention_flash`` alone against the reference's for the
  local and chunked masks at hd 64 and 256 with a small block, forward
  and gradients, and the route rule (B8 for full attention at hd 32, 64
  and 128 only).

Tolerances: logits and layer outputs within 1e-5 absolute (magnitude
~1, f32 sums in another order; 3e-5 at S 2,048); the loss within 1e-5;
gradients within 1e-5 of each leaf's largest (f32 sums over up to
2,048 tokens, the scan's backward in another order); the driver's
losses within 5e-5 (Adam at lr 1e-2 turns a rounding difference of a
gradient near 0 into a step of up to lr).
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
from repro.models import backbone as jbb
from repro.models import layers as jl
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.kernels import linear_scan as LS
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.launch.train import build_parser, run_lm
from repro_torch.models import api, backbone
from repro_torch.models import layers as tl
from repro_torch.models.tree import from_ref

ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
# (B, S) of the driver steps: two scan chunks for falcon-mamba; the
# blockwise local route (S >= 2,048) for recurrentgemma
RUN = {"falcon-mamba-7b": (2, 512), "recurrentgemma-2b": (1, 2048)}
STEPS, SEED, LR = 3, 0, 1e-2
TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-5, 5e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(arch, seed=0, **over):
    jcfg = dataclasses.replace(jget(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = japi.init_model(jax.random.key(seed), jcfg)
    model = backbone.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


# recurrentgemma at 5 layers: a (rglru, rglru, local) group and two rest
# layers, as the full model's 8 groups and 2 rest
REST = {"n_layers": 5}


@pytest.mark.parametrize("arch,B,S,over", [
    ("falcon-mamba-7b", 2, 64, {}), ("recurrentgemma-2b", 2, 64, REST),
    ("recurrentgemma-2b", 1, 2048, {})])
def test_forward_and_loss_match_reference(arch, B, S, over):
    jcfg, params, cfg, model = _models(arch, seed=1, **over)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jbb.forward(p, jcfg, t, remat=False))(
        params, jnp.asarray(toks))
    want_loss = jbb.lm_loss(params, jcfg, jnp.asarray(toks),
                            jnp.asarray(labels), remat=False)
    n0 = dict(LS.LAUNCHES)
    with torch.no_grad():
        got, aux = backbone.forward(model, cfg, _t(toks))
        loss = backbone.lm_loss(model, cfg, _t(toks), _t(labels))
    assert LS.LAUNCHES == n0                   # CPU: the plain scan
    assert float(aux) == 0.0
    # at S 2,048 three RG-LRU layers carry f32 rounding over 2,048 steps
    # and the local layer's online softmax rescales over 4 key blocks, in
    # other orders: 3e-5 there, as the dense prefill test allows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5 if S >= 2048 else TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=TOL)


_REFERENCE: dict = {}


def _reference(arch):
    """The reference's unsharded jitted step, 3 steps: (initial tree,
    step 0's gradients, losses)."""
    if arch not in _REFERENCE:
        B, S = RUN[arch]
        cfg = jget(arch, smoke=True)
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
        _REFERENCE[arch] = (tree, grads0, losses)
    return _REFERENCE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_gradients_match_leaf_by_leaf(arch):
    tree, grads0, _ = _reference(arch)
    B, S = RUN[arch]
    cfg = get_config(arch, smoke=True)
    model = backbone.params_from_jax(tree, cfg)
    tok = torch.as_tensor(next(jtokens(SEED, cfg.vocab, B, S + 1)))
    loss = api.train_loss(model, cfg, {"tokens": tok[:, :-1],
                                       "labels": tok[:, 1:]})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = from_ref(grads0, backbone.ref_paths(model, cfg))
    if arch == "falcon-mamba-7b":   # a layer: norm1, 11 Mamba leaves
        assert len(names) == 2 + 12 * cfg.n_layers
    for name, g, w in zip(names, grads, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_losses_match_the_reference_step(arch):
    tree, _, want = _reference(arch)
    B, S = RUN[arch]
    cfg = get_config(arch, smoke=True)
    args = build_parser().parse_args(
        ["--arch", arch, "--smoke", "--seq-len", str(S), "--batch-per-worker",
         str(B), "--steps", str(STEPS), "--seed", str(SEED), "--lr", str(LR),
         "--device", "cpu"])
    n0 = dict(LS.LAUNCHES)
    out = run_lm(args, model=backbone.params_from_jax(tree, cfg))
    assert LS.LAUNCHES == n0                   # CPU: no kernel launch
    assert out["steps"] == STEPS and out["seq_len"] == S
    got = [r["loss"] for r in out["metrics"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert got[-1] < got[0]


def _ref_layer_caches(jcache, cfg):
    """Each layer's cache from the reference's grouped cache, as numpy."""
    n_groups, gkinds, rkinds = jbb.group_layout(cfg)
    out = [{k: np.asarray(v[g]) for k, v in jcache["groups"][f"l{i}"].items()}
           for g in range(n_groups) for i in range(len(gkinds))]
    return out + [{k: np.asarray(v)
                   for k, v in jcache["rest"][f"l{i}"].items()}
                  for i in range(len(rkinds))]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """8 steps at B 2 into 16 slots (recurrentgemma at 5 layers, its
    local layer a ring of min(64, 16) = 16): logits within 1e-5, every
    layer's cache entries within 1e-5 absolute and relative (positions
    equal)."""
    jcfg, params, cfg, model = _models(
        arch, seed=3, **(REST if arch == "recurrentgemma-2b" else {}))
    toks = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (2, 8)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: japi.decode_step(p, jcfg, t, c, pos))
    jcache = japi.init_decode_cache(jcfg, 2, 16)
    cache = api.init_decode_cache(cfg, 2, 16, "cpu")
    for pos in range(8):
        want, jcache = jstep(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jcache, jnp.asarray(pos, jnp.int32))
        got, cache = api.decode_step(model, cfg, _t(toks[:, pos:pos + 1]),
                                     cache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=f"step {pos}")
    ref = _ref_layer_caches(jcache, jcfg)
    assert len(cache) == len(ref) == cfg.n_layers
    for i, (c, r) in enumerate(zip(cache, ref)):
        assert set(c) == set(r), i
        for k in c:
            if k == "pos":
                np.testing.assert_array_equal(c[k].numpy(), r[k])
            else:      # activations of the deeper layers reach ~2
                np.testing.assert_allclose(c[k].numpy(), r[k], rtol=TOL,
                                           atol=TOL, err_msg=f"{i} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_own_prefill(arch):
    """Teacher-forced decode gives the port's own prefill logits (the
    RG-LRU and Mamba states carry the sequence; recurrentgemma's local
    layers keep a ring of min(64, 24) slots)."""
    _, _, cfg, model = _models(arch, seed=5)
    toks = _t(np.random.default_rng(6).integers(0, cfg.vocab, (2, 24)))
    full = make_prefill_step(cfg)(model, {"tokens": toks})
    cache = api.init_decode_cache(cfg, 2, 24, "cpu")
    step = make_serve_step(cfg)
    for t in range(24):
        lg, cache = step(model, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=TOL, err_msg=f"pos {t}")


def _qkv(seed, B, S, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("kind,window", [("local", 48), ("chunked", 64)])
@pytest.mark.parametrize("hd", [64, 256])
def test_blockwise_attention_matches_reference(kind, window, hd):
    """S 256 in key blocks of 64: forward within 1e-5, and the gradients
    of a weighted sum through autograd against ``jax.grad`` within 1e-4
    (two more reductions over 256 keys)."""
    q, k, v = _qkv(hd + window, 2, 256, 2, 2, hd)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    pos = np.arange(256)

    def f(q_, k_, v_):
        out = jl.attention_flash(q_, k_, v_, kind, window, jnp.asarray(pos),
                                 jnp.asarray(pos), block=64)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    assert tl.flash_route(kind, hd) == "blockwise"
    got = tl.attention_flash(tq, tk, tv, kind, window, _t(pos), _t(pos),
                             block=64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    (got * _t(w)).sum().backward()
    for name, a, b in zip("qkv", jgrads, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("kind,hd,route", [
    ("full", 32, "b8"), ("full", 64, "b8"), ("full", 128, "b8"),
    ("full", 256, "blockwise"), ("local", 64, "blockwise"),
    ("local", 256, "blockwise"), ("chunked", 128, "blockwise")])
def test_flash_route(kind, hd, route):
    """The route follows the mask and hd only: recurrentgemma's local
    layers (hd 256) and llama4-scout's chunked ones take the blockwise
    scan, full attention at B8's head widths takes B8."""
    assert tl.flash_route(kind, hd) == route


def test_full_attention_at_hd_256_matches_reference():
    """Full attention at an hd B8 does not take: the blockwise route at
    S 2,048, against the reference's scan."""
    q, k, v = _qkv(8, 1, 2048, 1, 2, 256)
    pos = jnp.arange(2048)
    want = jl.attention_flash(*map(jnp.asarray, (q, k, v)), "full", 0, pos,
                              pos)
    got = tl.attention_flash(_t(q), _t(k), _t(v), "full")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_bf16_decode_keeps_the_state_in_f32():
    """In bf16 the recurrent layers keep their state f32 and their conv
    window in the activation dtype, as the reference's caches."""
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="bfloat16")
        jcfg = dataclasses.replace(jget(arch, smoke=True), dtype="bfloat16")
        ref = _ref_layer_caches(japi.init_decode_cache(jcfg, 2, 8), jcfg)
        for c, r in zip(api.init_decode_cache(cfg, 2, 8, "cpu"), ref):
            for k in c:
                assert tuple(c[k].shape) == r[k].shape, (arch, k)
                assert str(c[k].dtype).split(".")[-1] == str(r[k].dtype), \
                    (arch, k)
