"""The LM side's modules on the CPU against the JAX package's.

Layers (``rmsnorm``, ``rope``, the four MLP kinds, ``attention_naive``,
``attention_train`` on both of its routes), the backbone's ``forward``
and ``lm_loss`` through ``params_from_jax``, ``adam`` and
``token_stream``; then what the slice does not carry, which must raise.
Inputs and weights are numpy draws of one seed (the model weights the
reference's ``init_params``, carried across), all in f32.  Tolerances:
1e-5 absolute on layer outputs of magnitude ~1 and on logits (f32 sums
of up to d_ff products in another order), 1e-5 on the loss, and 1e-6
relative on Adam's parameters (the same f32 operations, but XLA's and
PyTorch's ``pow`` may round the bias corrections one ulp apart).
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
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.train import main
from repro_torch.models import api, backbone
from repro_torch.models import layers as tl
from repro_torch.optim import adam

TOL = 1e-5
DENSE = ("smollm-360m", "yi-9b", "minitron-4b", "granite-34b")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm():
    x, w = _x(0, 2, 5, 96), _x(1, 96) * 0.1
    np.testing.assert_allclose(tl.rmsnorm(_t(x), _t(w), 1e-6).numpy(),
                               _np(jl.rmsnorm(x, w, 1e-6)), rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 16, 2, 3, 64), (2, 16, 2, 32)])
def test_rope(shape):
    x = _x(2, *shape) * 3
    pos = np.arange(100, 116)
    np.testing.assert_allclose(
        tl.rope(_t(x), _t(pos), 10_000.0).numpy(),
        _np(jl.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=0, atol=1e-4)     # |x| up to ~12, angles up to 115 rad


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_kinds(kind):
    cfg = dataclasses.replace(jget("smollm-360m", smoke=True), mlp=kind)
    p = jl.init_mlp(jax.random.key(3), cfg, jnp.float32)
    x = _x(4, 2, 8, cfg.d_model)
    want = jl.mlp(p, jnp.asarray(x), kind)
    mod = tl.MLP(_t(p["wi"]["w"]), _t(p["wo"]["w"]),
                 _t(p["wg"]["w"]) if "wg" in p else None)
    np.testing.assert_allclose(tl.mlp(mod, _t(x), kind).detach().numpy(),
                               _np(want), rtol=0, atol=TOL)


def _attn(cfg, seed):
    p = jl.init_attention(jax.random.key(seed), cfg, jnp.float32)
    return p, tl.Attention(*(_t(p[n]) for n in ("wq", "wk", "wv", "wo")))


@pytest.mark.parametrize("kind,window,bidir", [
    ("full", 0, False), ("local", 24, False), ("chunked", 32, False),
    ("full", 0, True)])
def test_attention_naive(kind, window, bidir):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 96, 2, 2, 64)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)
    pos = np.arange(96)
    want = jl.attention_naive(q, k, v, kind, window, jnp.asarray(pos),
                              jnp.asarray(pos), bidirectional=bidir)
    got = tl.attention_naive(_t(q), _t(k), _t(v), kind, window, _t(pos),
                             _t(pos), bidirectional=bidir)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("S,kind", [(128, "full"), (128, "nope"),
                                    (128, "local"), (2048, "full")])
def test_attention_train_both_routes(S, kind):
    """S = 128 takes the naive route, S = 2048 the flash route (B8)."""
    cfg = dataclasses.replace(jget("smollm-360m", smoke=True), window=48)
    p, mod = _attn(cfg, 6)
    x = _x(7, 1, S, cfg.d_model)
    pos = np.arange(S)
    want = jl.attention_train(p, jnp.asarray(x), cfg, kind, jnp.asarray(pos))
    tcfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                               window=48)
    got = tl.attention_train(mod, _t(x), tcfg, kind, _t(pos))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0,
                               atol=TOL)


def test_local_attention_at_flash_length_raises():
    """Local attention at S = 2,048 raised until the blockwise route
    (ROADMAP A14.8); it now runs that route and matches the reference's
    ``attention_train`` (3e-5: the online softmax over 4 key blocks in
    another order)."""
    jcfg = dataclasses.replace(jget("smollm-360m", smoke=True), window=64)
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              window=64)
    p, mod = _attn(jcfg, 8)
    x = _x(9, 1, 2048, cfg.d_model)
    pos = np.arange(2048)
    want = jl.attention_train(p, jnp.asarray(x), jcfg, "local",
                              jnp.asarray(pos))
    got = tl.attention_train(mod, _t(x), cfg, "local", _t(pos))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0,
                               atol=3e-5)


def _jax_model(arch, seed=0):
    cfg = jget(arch, smoke=True)
    params = japi.init_model(jax.random.key(seed), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_through_params_from_jax(arch):
    jcfg, params, tree = _jax_model(arch)
    cfg = get_config(arch, smoke=True)
    model = backbone.params_from_jax(tree, cfg)
    assert len(model.layers) == cfg.n_layers
    assert (model.lm_head is None) == cfg.tie_embeddings
    batch = api.make_train_batch(np.random.default_rng(8), cfg, 2, 64)
    batch["labels"][0, :5] = -1                    # padded labels
    logits, _ = jbb.forward(params, jcfg, jnp.asarray(batch["tokens"]),
                            remat=False)
    got, aux = backbone.forward(model, cfg, _t(batch["tokens"]))
    assert aux.item() == 0.0                       # no MoE layer
    np.testing.assert_allclose(got.detach().numpy(), _np(logits), rtol=0,
                               atol=TOL)
    want = japi.train_loss(params, jcfg, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, remat=False)
    loss = api.train_loss(model, cfg, {k: _t(v) for k, v in batch.items()})
    assert abs(loss.detach().item() - float(want)) < TOL


def test_tied_embedding_takes_both_gradients():
    """smollm ties the head to the embedding: the one parameter's
    gradient is the gather's plus the head's, as JAX's."""
    jcfg, params, tree = _jax_model("smollm-360m")
    cfg = get_config("smollm-360m", smoke=True)
    model = backbone.params_from_jax(tree, cfg)
    batch = api.make_train_batch(np.random.default_rng(9), cfg, 1, 32)
    g = jax.grad(japi.train_loss)(params, jcfg, {k: jnp.asarray(v) for k, v
                                                 in batch.items()},
                                  remat=False)
    loss = api.train_loss(model, cfg, {k: _t(v) for k, v in batch.items()})
    (ge,) = torch.autograd.grad(loss, [model.embed])
    np.testing.assert_allclose(ge.numpy(), _np(g["embed"]), rtol=0,
                               atol=1e-6)


def test_params_from_jax_keeps_bf16_bits():
    jcfg = dataclasses.replace(jget("yi-9b", smoke=True), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, japi.init_model(jax.random.key(1), jcfg))
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="bfloat16")
    model = backbone.params_from_jax(tree, cfg)
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].norm1.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].attn.wo.detach().float().numpy(),
        tree["groups"]["l0"]["attn"]["wo"][1].astype(np.float32))


def test_init_params_shapes_and_dtypes():
    cfg = get_config("smollm-360m")
    small = dataclasses.replace(cfg, n_layers=2, vocab=512)
    model = backbone.init_params(small, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda: japi.init_model(
        jax.random.key(0), dataclasses.replace(jget("smollm-360m"),
                                               n_layers=2, vocab=512)))
    assert model.embed.shape == jtree["embed"].shape
    assert model.embed.dtype == torch.bfloat16
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(getattr(model.layers[0].attn, name).shape) == \
            jtree["groups"]["l0"]["attn"][name].shape[1:]
    assert model.final_norm.dtype == torch.float32
    assert not model.final_norm.detach().any()
    n = sum(p.numel() for p in model.parameters())
    assert n == small.param_count() + small.d_model     # + final_norm


def test_adam_matches_reference():
    rng = np.random.default_rng(10)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jo = jopt.adam(1e-2)
    js = jo.init({k: jnp.asarray(v) for k, v in params.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    to = adam(1e-2)
    tp = [_t(params[k]) for k in shapes]
    ts = to.init(tp)
    for step in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 * 10.0 ** -step for k, s in shapes.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = to.update([_t(grads[k]) for k in shapes], ts, tp)
    assert int(ts["t"]) == int(js["t"]) == 4 and ts["t"].dtype == torch.int32
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(tp[i].numpy(), _np(jp[k]), rtol=1e-6)
        np.testing.assert_allclose(ts["nu"][i].numpy(), _np(js["nu"][k]),
                                   rtol=1e-6)


def test_token_stream_equals_reference():
    a, b = token_stream(3, 1024, 2, 65), jtokens(3, 1024, 2, 65)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


@pytest.mark.parametrize("flags,item", [
    (["--trace-out", "t.json"], "A15"), (["--validate-timing"], "A15")])
def test_unported_lm_flags_raise(flags, item, tmp_path, capsys):
    """The trace flags of ROADMAP A15 are ported in LM mode too: each
    runs, raises nothing and traces the step's ``train.sync``."""
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    out = main(["--arch", "smollm-360m", "--smoke", "--steps", "1",
                "--device", "cpu"] + flags)
    assert out["steps"] == 1
    assert "train.sync" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--ckpt-dir", "CKPT"], ["--resume"]])
def test_lm_checkpoint_flags_run(flags, tmp_path):
    """``--ckpt-dir`` writes the reference's {params, opt} checkpoints
    (their parity is tests/test_torch_checkpoint.py); ``--resume`` alone
    is refused with the reference's message."""
    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "2",
            "--seq-len", "16", "--device", "cpu", "--ckpt-every", "1"]
    if flags == ["--resume"]:
        with pytest.raises(SystemExit, match="--resume needs --ckpt-dir"):
            main(argv + flags)
        return
    out = main(argv + ["--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 2
    with np.load(tmp_path / "ckpt_00000002.npz") as data:
        assert int(data["opt::t"]) == 2 and "params::embed" in data.files


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_moe_families_train_one_smoke_step(arch):
    """The MoE families train through the driver (their parity with the
    reference is tests/test_torch_moe.py)."""
    out = main(["--arch", arch, "--smoke", "--steps", "1", "--device",
                "cpu"])
    assert out["steps"] == 1 and np.isfinite(out["metrics"][0]["loss"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_ssm_families_train_one_smoke_step(arch):
    """The SSM and hybrid families train through the driver (their
    parity with the reference is tests/test_torch_ssm_slice.py)."""
    out = main(["--arch", arch, "--smoke", "--steps", "1", "--device",
                "cpu"])
    assert out["steps"] == 1 and np.isfinite(out["metrics"][0]["loss"])
    cfg = get_config(arch, smoke=True)
    model = backbone.init_params(cfg, generator=torch.Generator(),
                                 device="cpu")
    assert len(model.layers) == cfg.n_layers


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-large-v3"])
def test_families_outside_the_slice_raise(arch):
    """The LM driver feeds ``{tokens, labels}`` only, as the reference's:
    the reference's ``train_loss`` fails on that batch (no ``patches`` or
    ``frames``), and the port's driver refuses the VLM and audio families
    with a ``SystemExit`` naming the step they train through.  That step's
    loss runs on ``make_train_batch``'s batch (their parity with the
    reference is tests/test_torch_vlm.py and test_torch_whisper.py)."""
    with pytest.raises(SystemExit, match="make_train_step"):
        main(["--arch", arch, "--smoke", "--steps", "1", "--device", "cpu"])
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    toks = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(KeyError, match="patches|frames"):
        japi.train_loss(japi.init_model(jax.random.key(0), jcfg), jcfg,
                        {"tokens": toks, "labels": toks}, remat=False)
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    batch = api.make_train_batch(np.random.default_rng(0), cfg, 1, 32)
    loss = api.train_loss(model, cfg, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    assert loss.shape == () and np.isfinite(loss.item())
