"""The LM's serving path on the CPU against the JAX package's: decode
over the KV cache, the ring buffer, decode against the forward, prefill,
and the decode example.

Weights are the reference's ``init_params`` carried across with
``params_from_jax``; tokens are numpy draws of one seed.  The reference
runs under ``jax.jit``, as its decode example drives it.  Tolerances: 1e-5
absolute on f32 logits of magnitude ~1 (sums of up to d_ff products in
another order), and each layer's cache ``pos`` equal.  The card tests
in ``test_torch_lm_cuda.py`` hold decode on the card against the CPU.
"""
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import backbone as jbb
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as tf
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api, backbone, whisper

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ARCHS = ("smollm-360m", "yi-9b", "minitron-4b", "granite-34b",
         "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "pixtral-12b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(arch, seed=0, **over):
    jcfg = dataclasses.replace(jget(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = japi.init_model(jax.random.key(seed), jcfg)
    module = whisper if cfg.family == "audio" else backbone
    model = module.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


def _ref_layer_pos(jcache, cfg):
    """Each layer's cache ``pos`` from the reference's grouped cache:
    layer g P + i is ``groups/l{i}`` at index g; the rest follow."""
    n_groups, gkinds, rkinds = jbb.group_layout(cfg)
    out = [np.asarray(jcache["groups"][f"l{i}"]["pos"][g])
           for g in range(n_groups) for i in range(len(gkinds))]
    return out + [np.asarray(jcache["rest"][f"l{i}"]["pos"])
                  for i in range(len(rkinds))]


def _decode_both(arch, steps, B, slots, seed=0, **over):
    jcfg, params, cfg, model = _models(arch, seed, **over)
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, steps)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: japi.decode_step(p, jcfg, t, c, pos))
    jcache = japi.init_decode_cache(jcfg, B, slots)
    cache = api.init_decode_cache(cfg, B, slots, "cpu")
    got, want = [], []
    for pos in range(steps):
        jl, jcache = jstep(params, jnp.asarray(toks[:, pos:pos + 1]), jcache,
                           jnp.asarray(pos, jnp.int32))
        lg, cache = api.decode_step(model, cfg, _t(toks[:, pos:pos + 1]),
                                    cache, pos)
        want.append(np.asarray(jl))
        got.append(lg.numpy())
    return jcfg, cfg, got, want, cache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """8 steps into 16 slots: logits within 1e-5, every layer's cache
    positions equal.  phi3.5-moe decodes through its MoE layers (C =
    ceil(1.25 * 2 * 2 / 4) = 2 at B 2, top-2 of 4); llama4-scout through
    the chunked mask, its NoPE global layer and the shared expert (C =
    1: tokens dropped where both pick one expert); pixtral its text
    tokens, as the reference's decode does."""
    jcfg, cfg, got, want, cache, jcache = _decode_both(arch, 8, 2, 16)
    for step, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                   err_msg=f"step {step}")
    ref_pos = _ref_layer_pos(jcache, jcfg)
    assert len(cache) == len(ref_pos) == cfg.n_layers
    for i, (c, p) in enumerate(zip(cache, ref_pos)):
        np.testing.assert_array_equal(c["pos"].numpy(), p, err_msg=str(i))
        assert c["k"].shape == (2, 16, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("kind", ["local", "chunked"])
def test_ring_buffer_wraps(kind):
    """A window of 4 slots and 11 steps: the ring wraps twice, and the
    mask keeps only the positions the window allows."""
    over = dict(layer_pattern=(kind,), window=4)
    jcfg, cfg, got, want, cache, jcache = _decode_both(
        "smollm-360m", 11, 2, 16, **over)
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                   err_msg=f"step {step}")
    for c, p in zip(cache, _ref_layer_pos(jcache, jcfg)):
        assert c["k"].shape[1] == 4
        np.testing.assert_array_equal(c["pos"].numpy(), p)
        assert sorted(c["pos"].tolist()) == [7, 8, 9, 10]


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-34b"])
def test_decode_equals_own_forward(arch):
    """Teacher-forced decode gives the port's own forward logits (the
    reference's tests/test_models_smoke.py check, on the port)."""
    _, _, cfg, model = _models(arch, seed=3)
    toks = _t(np.random.default_rng(4).integers(0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        full, _ = backbone.forward(model, cfg, toks)
    cache = api.init_decode_cache(cfg, 2, 12, "cpu")
    step = make_serve_step(cfg)
    for t in range(12):
        lg, cache = step(model, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=TOL, err_msg=f"pos {t}")


@pytest.mark.parametrize("arch,B,S", [
    ("smollm-360m", 2, 64), ("phi3.5-moe-42b-a6.6b", 2, 64),
    ("llama4-scout-17b-a16e", 2, 64), ("smollm-360m", 1, 2048)])
def test_prefill_matches_reference(arch, B, S):
    """``make_prefill_step`` against the reference's: logits within
    1e-5 absolute and 1e-5 relative (llama4-scout's four layers, with
    the shared expert, give logits up to ~2, where f32 sums in another
    order differ by tens of ulps).  At S = 2,048 every layer takes B8
    (its plain version on the CPU; the reference's jnp flash scan), whose
    online softmax rescales its f32 sums over 2,048 keys in another
    order: 3e-5 absolute there."""
    jcfg, params, cfg, model = _models(arch, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab,
                                             (B, S)).astype(np.int32)
    want = jax.jit(jsteps.make_prefill_step(jcfg, remat=False))(
        params, {"tokens": jnp.asarray(toks)})
    n0 = tf.LAUNCHES["flash_attention"]
    got = make_prefill_step(cfg)(model, {"tokens": _t(toks)})
    assert tf.LAUNCHES["flash_attention"] == n0      # CPU: no launch
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=3e-5 if S >= 2048 else TOL)


def test_decode_runs_without_autograd():
    """The cache is written in place: no graph may ride it from step to
    step, even with parameters that take gradients."""
    _, _, cfg, model = _models("smollm-360m")
    cache = api.init_decode_cache(cfg, 1, 4, "cpu")
    lg, cache = api.decode_step(model, cfg, torch.zeros((1, 1),
                                                        dtype=torch.long),
                                cache, 0)
    assert not lg.requires_grad
    assert all(c["k"].grad_fn is None for c in cache)


@pytest.mark.parametrize("arch,item", [("whisper-large-v3", "A14.6")])
def test_decode_outside_the_slice_raises(arch, item):
    """The audio family decodes (ROADMAP A14.6): the decode example's loop
    over whisper's self-KV rings and zero cross K/V of ``enc_len =
    prompt_len + gen_len`` frames gives the reference's example loop's
    tokens."""
    out, want = _example_against_reference(arch)
    np.testing.assert_array_equal(out["sequences"], want)
    cache = api.init_decode_cache(get_config(arch, smoke=True), 2, 11, "cpu")
    assert set(cache) == {"self", "cross_k", "cross_v"}
    assert cache["cross_k"].shape[2] == 11, item


@pytest.mark.parametrize("arch,item", [("pixtral-12b", "A14.5"),
                                       ("whisper-large-v3", "A14.6")])
def test_prefill_outside_the_slice_raises(arch, item):
    """``make_prefill_step`` runs the VLM (ROADMAP A14.5: tokens behind
    their patches, the logits over all P + S positions) and the audio
    family (A14.6: encode, then the decoder's logits) as the reference's
    under ``jax.jit``, on ``make_train_batch``'s batch."""
    jcfg, params, cfg, model = _models(arch, seed=5)
    batch = api.make_train_batch(np.random.default_rng(6), cfg, 2, 48)
    want = jax.jit(jsteps.make_prefill_step(jcfg, remat=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_prefill_step(cfg)(model, {k: _t(v) for k, v in batch.items()})
    assert not got.requires_grad and got.shape == (2, 48, cfg.vocab), item
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _example():
    return runpy.run_path(str(ROOT / "examples" /
                              "serve_llm_decode_torch.py"))


def _example_against_reference(arch):
    """The example's loop (teacher-forced prompt, then greedy) on the
    reference's weights, and the reference's example loop's tokens."""
    ex = _example()
    args = ex["build_parser"]().parse_args(
        ["--arch", arch, "--batch", "2", "--prompt-len", "5", "--gen-len",
         "6", "--device", "cpu"])
    jcfg, params, cfg, model = _models(args.arch)
    out = ex["run"](args, cfg=cfg, model=model)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5))
    step = jax.jit(lambda p, t, c, pos: japi.decode_step(p, jcfg, t, c, pos))
    cache = japi.init_decode_cache(jcfg, 2, 11)
    tok = jnp.asarray(prompts[:, :1], jnp.int32)
    seq = [np.asarray(tok)]
    for pos in range(10):
        logits, cache = step(params, tok, cache, jnp.asarray(pos, jnp.int32))
        tok = (jnp.asarray(prompts[:, pos + 1:pos + 2], jnp.int32)
               if pos + 1 < 5 else
               jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
        seq.append(np.asarray(tok))
    return out, np.concatenate(seq, 1)


def test_decode_example_matches_reference_loop():
    out, want = _example_against_reference("phi3.5-moe-42b-a6.6b")
    np.testing.assert_array_equal(out["sequences"], want)
    assert out["steps"] == 10 and out["device"] == "cpu"
    assert out["tok_per_s"] > 0 and out["step_p99_ms"] >= out["step_p50_ms"]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_decode_example_runs_the_recurrent_families(arch):
    """The SSM and hybrid families decode (they raised until ROADMAP
    A14.4): the example's tokens are the reference's loop's, each layer's
    cache a conv window and an f32 state (a KV ring for recurrentgemma's
    local layers)."""
    out, want = _example_against_reference(arch)
    np.testing.assert_array_equal(out["sequences"], want)
    cfg = get_config(arch, smoke=True)
    cache = api.init_decode_cache(cfg, 2, 11, "cpu")
    for kind, c in zip(cfg.kinds(), cache):
        want_keys = {"mamba": {"conv", "ssm"}, "rglru": {"conv", "h"}}.get(
            kind, {"k", "v", "pos"})
        assert set(c) == want_keys, kind


def test_decode_example_cli_runs():
    ex = _example()
    out = ex["main"](["--arch", "llama4-scout-17b-a16e", "--batch", "2",
                      "--prompt-len", "3", "--gen-len", "4", "--device",
                      "cpu"])
    assert out["sequences"].shape == (2, 7)
