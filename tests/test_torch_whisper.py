"""The audio encoder-decoder (whisper-large-v3's smoke config) on the CPU:
repro_torch against the JAX package.

The reference's ``init_params`` is carried across with
``whisper.params_from_jax``; frames, tokens and labels are the batches
of ``api.make_train_batch`` drawn from one numpy seed in each package.
Held against the reference:

- ``make_train_batch``'s draws, bit for bit;
- ``encode`` (bidirectional, the naive route), ``decode_train``,
  ``loss`` and step 0's gradients leaf by leaf (``jax.grad``);
- 3 steps of ``make_train_step`` against the reference's unsharded
  jitted ``value_and_grad(api.train_loss, remat=False)`` and ``adam``
  (its LM driver fails: ROADMAP C-ref-4), in f32 and in bf16;
- ``make_prefill_step`` against the reference's;
- ``init_cache``, and ``decode_step`` under ``jax.jit`` over zero cross
  K/V, over cross K/V filled from the encoder's memory (then also
  against ``decode_train``'s logits), and past the 448-slot ring;
- the parameter trees both ways.

Tolerances: f32 outputs and losses within 1e-5 absolute (magnitudes ~1,
f32 sums in another order); gradients within 1e-5 of each leaf's
largest; the 3 steps' losses within 5e-5 (Adam at lr 1e-2 turns a
rounding difference of a gradient near 0 into a step of up to lr); bf16
losses within 2e-2 (the bf16 LM slice's tolerance).
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
from repro.models import whisper as jw
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import api, whisper
from repro_torch.models.tree import from_ref
from repro_torch.optim import get_optimizer

ARCH = "whisper-large-v3"
TOL, GRAD_TOL, LOSS_TOL, BF16_TOL = 1e-5, 1e-5, 5e-5, 2e-2
STEPS, LR = 3, 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(seed=0, **over):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), **over)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    params = japi.init_model(jax.random.key(seed), jcfg)
    model = whisper.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


def _batch(cfg, seed, B=2, S=64):
    return api.make_train_batch(np.random.default_rng(seed), cfg, B, S)


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("S", [64, 500])
def test_make_train_batch_draws_equal(S):
    """The frames (B, S, D) and the decoder's min(S, 448) tokens and
    labels, bit for bit the reference's draws."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget(ARCH, smoke=True)
    got = api.make_train_batch(np.random.default_rng(3), cfg, 2, S)
    want = japi.make_train_batch(np.random.default_rng(3), jcfg, 2, S)
    assert set(got) == set(want) == {"frames", "tokens", "labels"}
    assert got["tokens"].shape == (2, min(S, whisper.DEC_CTX))
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_api_builds_the_audio_model():
    """``api.init_model`` builds a ``Whisper`` with the reference's leaf
    shapes and dtypes (its ``init_params``), leaf for leaf."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget(ARCH, smoke=True)
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert isinstance(model, whisper.Whisper)
    assert len(model.enc) == cfg.encoder_layers
    assert len(model.dec) == cfg.n_layers
    want = japi.init_model(jax.random.key(0), jcfg)
    paths = whisper.ref_paths(model, cfg)
    for p, w, (path, _) in zip(model.parameters(), from_ref(want, paths),
                               paths, strict=True):
        assert tuple(p.shape) == tuple(w.shape), path
        assert str(p.dtype).split(".")[-1] == str(w.dtype), path
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))


def test_encode_decode_train_and_loss_match_reference():
    """``encode`` at 64 frames (bidirectional, the naive route),
    ``decode_train`` over its memory and ``loss`` with padded labels."""
    jcfg, params, cfg, model = _models(seed=1)
    b = _batch(cfg, 2)
    b["labels"][:, -5:] = -1
    mem_want = jw.encode(params, jcfg, jnp.asarray(b["frames"]), remat=False)
    lg_want = jw.decode_train(params, jcfg, jnp.asarray(b["tokens"]),
                              mem_want, remat=False)
    loss_want = jw.loss(params, jcfg, *map(jnp.asarray, (
        b["frames"], b["tokens"], b["labels"])), remat=False)
    with torch.no_grad():
        mem = whisper.encode(model, cfg, _t(b["frames"]))
        lg = whisper.decode_train(model, cfg, _t(b["tokens"]), mem)
        loss = api.train_loss(model, cfg, _tb(b))
    assert mem.shape == (2, 64, cfg.d_model)
    assert lg.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(loss), float(loss_want), rtol=0,
                               atol=TOL)


def test_cross_attention_matches_reference():
    """``layers.cross_attention`` alone: the query projected without RoPE,
    every key attended, at 3 queries over 40 encoder positions."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    jcfg, params, cfg, model = _models(seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, cfg.n_kv_heads, cfg.hd))
            .astype(np.float32) for _ in range(2))
    xp = jax.tree.map(lambda a: a[0], params["dec"]["xattn"])
    want = jl.cross_attention(xp, *map(jnp.asarray, (x, k, v)))
    got = tl.cross_attention(model.dec[0].xattn, _t(x), _t(k), _t(v))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


def test_step0_gradients_match_leaf_by_leaf():
    """Every leaf's gradient, ``xattn``'s ``wk`` and ``wv`` (read only
    through the encoder's memory) among them."""
    jcfg, params, cfg, model = _models(seed=4)
    b = _batch(cfg, 5)
    g_want = jax.grad(lambda p: japi.train_loss(p, jcfg, _jb(b),
                                                remat=False))(params)
    loss = api.train_loss(model, cfg, _tb(b))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    want = from_ref(jax.tree.map(np.asarray, g_want),
                    whisper.ref_paths(model, cfg))
    assert "dec.0.xattn.wk" in names and "dec.1.xattn.wv" in names
    for name, g, w in zip(names, grads, want, strict=True):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(w).max())), err_msg=name)


def _reference_steps(jcfg, batches, seed=0):
    params = japi.init_model(jax.random.key(seed), jcfg)
    opt = jopt.adam(LR)

    @jax.jit
    def step(p, o, batch):
        loss, g = jax.value_and_grad(japi.train_loss)(p, jcfg, batch,
                                                      remat=False)
        p, o = opt.update(g, o, p)
        return p, o, loss

    p, o, losses = params, opt.init(params), []
    for b in batches:
        p, o, loss = step(p, o, _jb(b))
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@pytest.mark.parametrize("dtype,tol", [("float32", LOSS_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_train_steps_match_the_reference_step(dtype, tol):
    """3 steps of ``make_train_step`` (Adam, lr 1e-2) at B 2, 64 frames,
    64 tokens, on one ``make_train_batch`` batch (so the loss falls)."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype=dtype)
    batches = [_batch(cfg, 6)] * STEPS
    tree, want = _reference_steps(jcfg, batches)
    model = whisper.params_from_jax(tree, cfg)
    step = make_train_step(cfg, model, get_optimizer("adam", LR),
                           remat=False)
    got = [float(step(_tb(b))) for b in batches]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert got[-1] < got[0]


def test_prefill_matches_reference():
    """``make_prefill_step``: encode the frames, then the decoder's logits
    (B, S_dec, V), without autograd."""
    jcfg, params, cfg, model = _models(seed=9)
    b = _batch(cfg, 10, B=2, S=48)
    want = jax.jit(jsteps.make_prefill_step(jcfg, remat=False))(params,
                                                                _jb(b))
    got = make_prefill_step(cfg)(model, _tb(b))
    assert not got.requires_grad and got.shape == (2, 48, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_init_cache_matches_reference():
    """448 self-KV slots a decoder layer (positions -1), zero cross K/V
    (L, B, enc_len, KV, hd); in f32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
        jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype=dtype)
        want = jw.init_cache(jcfg, 3, 20)
        got = api.init_decode_cache(cfg, 3, 20, "cpu")
        assert set(got) == set(want) == {"self", "cross_k", "cross_v"}
        assert len(got["self"]) == cfg.n_layers
        for key in ("cross_k", "cross_v"):
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
            assert not got[key].any()
        for i, c in enumerate(got["self"]):
            for key in ("k", "v", "pos"):
                w = np.asarray(want["self"][key][i])
                assert tuple(c[key].shape) == w.shape, key
                assert str(c[key].dtype).split(".")[-1] == str(w.dtype)
                np.testing.assert_array_equal(
                    c[key].float().numpy(), w.astype(np.float32))
        assert got["self"][0]["k"].shape[1] == whisper.DEC_CTX


def _ref_cross(params, jcfg, memory):
    """The reference's per-layer ``_enc_kv`` of ``memory``, stacked over
    the decoder's layers as its cache holds them."""
    L = jcfg.n_layers
    ks, vs = zip(*(jw._enc_kv(jax.tree.map(lambda a: a[i], params["dec"]),
                              memory, jcfg) for i in range(L)))
    return jnp.stack(ks), jnp.stack(vs)


def _decode(jcfg, params, cfg, model, toks, enc_len, memory=None,
            start=0):
    """Decode ``toks`` (B, n) teacher-forced in both packages from
    position ``start``; with ``memory`` (numpy (B, enc_len, D)) the cross
    K/V are filled from it.  Returns (port logits, reference logits, the
    port's cache, the reference's cache), logits (B, n, V)."""
    B, n = toks.shape
    jstep = jax.jit(lambda p, t, c, pos: japi.decode_step(p, jcfg, t, c, pos))
    jcache = japi.init_decode_cache(jcfg, B, enc_len)
    cache = api.init_decode_cache(cfg, B, enc_len, "cpu")
    if memory is not None:
        ck, cv = _ref_cross(params, jcfg, jnp.asarray(memory))
        jcache = {**jcache, "cross_k": ck, "cross_v": cv}
        whisper.fill_cross_kv(model, cfg, cache, _t(memory))
    step = make_serve_step(cfg)
    got, want = [], []
    for i in range(n):
        w, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.asarray(start + i, jnp.int32))
        g, cache = step(model, cache, _t(toks[:, i:i + 1]), start + i)
        want.append(np.asarray(w))
        got.append(g.numpy())
    return (np.concatenate(got, 1), np.concatenate(want, 1), cache, jcache)


def _same_self_cache(cache, jcache, cfg, atol=TOL):
    for i, c in enumerate(cache["self"]):
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(jcache["self"]["pos"][i]))
        for key in ("k", "v"):
            np.testing.assert_allclose(
                c[key].numpy(), np.asarray(jcache["self"][key][i]), rtol=0,
                atol=atol, err_msg=f"layer {i} {key}")


def test_decode_over_zero_cross_kv_matches_reference():
    """The reference's decode example's setting: 10 steps at B 2 over
    zero cross K/V of 11 frames (the cross-attention adds 0)."""
    jcfg, params, cfg, model = _models(seed=11)
    toks = np.random.default_rng(12).integers(0, cfg.vocab,
                                              (2, 10)).astype(np.int32)
    got, want, cache, jcache = _decode(jcfg, params, cfg, model, toks, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _same_self_cache(cache, jcache, cfg)
    assert not cache["cross_k"].any() and not cache["cross_v"].any()


def test_decode_over_filled_cross_kv_matches_decode_train():
    """Cross K/V filled from ``encode``'s memory of 24 frames: 12 decode
    steps against the reference's decode over its own ``_enc_kv``, and
    against ``decode_train``'s logits of the same tokens (both
    packages)."""
    jcfg, params, cfg, model = _models(seed=13)
    b = _batch(cfg, 14, B=2, S=24)
    toks = b["tokens"][:, :12]
    mem = np.asarray(jw.encode(params, jcfg, jnp.asarray(b["frames"]),
                               remat=False))
    got, want, cache, jcache = _decode(jcfg, params, cfg, model, toks, 24,
                                       memory=mem)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _same_self_cache(cache, jcache, cfg)
    np.testing.assert_allclose(cache["cross_k"].numpy(),
                               np.asarray(jcache["cross_k"]), rtol=0,
                               atol=TOL)
    with torch.no_grad():
        full = whisper.decode_train(model, cfg, _t(toks),
                                    whisper.encode(model, cfg,
                                                   _t(b["frames"])))
    jfull = jw.decode_train(params, jcfg, jnp.asarray(toks), jnp.asarray(mem),
                            remat=False)
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(want, np.asarray(jfull), rtol=0, atol=TOL)


def test_decode_past_the_ring_matches_reference():
    """460 steps at B 1 over filled cross K/V of 8 frames: from position
    448 on, slot ``pos % 448`` overwrites the oldest position, and the
    ring keeps the last 448 (positions and logits equal the
    reference's).  The cached keys within 1e-4: RoPE's f32 angles reach
    460 rad here (an ulp of 3e-5), and the two packages' frequencies and
    cosines differ in the last ulp, which moves keys of magnitude ~3 by
    up to 1e-4; the logits hold 1e-5."""
    jcfg, params, cfg, model = _models(seed=15)
    n = whisper.DEC_CTX + 12
    toks = np.random.default_rng(16).integers(0, cfg.vocab,
                                              (1, n)).astype(np.int32)
    mem = np.random.default_rng(17).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32)
    got, want, cache, jcache = _decode(jcfg, params, cfg, model, toks, 8,
                                       memory=mem)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _same_self_cache(cache, jcache, cfg, atol=1e-4)
    pos = cache["self"][0]["pos"].numpy()
    assert pos.min() == n - whisper.DEC_CTX and pos.max() == n - 1
    assert pos[0] == whisper.DEC_CTX and pos[11] == n - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    """``params_from_jax`` then ``params_to_jax`` gives the reference's
    tree back leaf for leaf, the stacked ``enc`` and ``dec`` axes too."""
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, japi.init_model(jax.random.key(2), jcfg))
    model = whisper.params_from_jax(tree, cfg)
    back = whisper.params_to_jax(model, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.float32),
                                      err_msg=str(path))
    if dtype == "bfloat16":
        assert model.dec[0].xattn.wk.dtype == torch.bfloat16
        assert model.enc_norm.dtype == torch.float32
    # and a port model's tree seeds the reference to the same loss
    m2 = api.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    t2 = whisper.params_to_jax(m2, cfg)
    b = _batch(cfg, 4, B=1, S=16)
    if dtype == "float32":
        want = japi.train_loss(jax.tree.map(jnp.asarray, t2), jcfg, _jb(b),
                               remat=False)
        with torch.no_grad():
            got = api.train_loss(m2, cfg, _tb(b))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=TOL)
