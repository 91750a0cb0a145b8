"""The MoE layers on the CPU against the JAX package's: ``moe_ffn`` and
its aux loss, the gradients of a phi3.5-moe ``lm_loss``, and 3 driver
steps of phi3.5-moe.

Inputs are numpy draws of one seed; the reference's weights come across
through ``params_from_jax`` (``init_moe``'s tree for one layer), all in
f32.  Tolerances: 1e-5 absolute on outputs of magnitude ~1 and on the
aux loss (f32 sums over d_model and d_ff in another order); the driver's
losses within 1e-4, as chip_smoke.py holds the LM's card-against-CPU
losses (Adam at lr 1e-2 turns a rounding difference of a gradient near
0 into a step of up to lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import token_stream as jtokens
from repro.models import api as japi
from repro.models import layers as jl
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.launch.train import build_parser, run_lm
from repro_torch.models import api, backbone
from repro_torch.models import layers as tl

TOL = 1e-5
PHI = "phi3.5-moe-42b-a6.6b"
LLAMA4 = "llama4-scout-17b-a16e"


def _t(x):
    return torch.from_numpy(np.array(x))


def _moe(p):
    shared = p.get("shared")
    if shared is not None:
        shared = tl.MLP(_t(shared["wi"]["w"]), _t(shared["wo"]["w"]),
                        _t(shared["wg"]["w"]))
    return tl.MoE(_t(p["router"]["w"]), _t(p["wi"]), _t(p["wg"]),
                  _t(p["wo"]), shared)


def _layer(arch, seed, tie=None):
    """The reference's MoE weights and the port's module over them;
    ``tie=(a, b)`` makes experts a and b's router columns equal, so
    every token's probabilities for the two tie exactly."""
    cfg = jget(arch, smoke=True)
    p = jax.tree.map(np.array, jl.init_moe(jax.random.key(seed), cfg,
                                           jnp.float32))
    if tie is not None:
        p["router"]["w"][:, tie[1]] = p["router"]["w"][:, tie[0]]
    return cfg, p, _moe(p)


@pytest.mark.parametrize("arch,B,S,cf,tie", [
    (PHI, 2, 16, 1.25, None),      # C = 20 of 64 pairs over 4 experts
    (PHI, 2, 16, 0.5, None),       # C = 8: many pairs dropped
    (PHI, 1, 24, 1.25, (1, 2)),    # top-2 ties on every token
    (PHI, 1, 24, 1.25, (0, 3)),
    (LLAMA4, 2, 16, 1.25, None),   # top-1 and the shared expert
    (LLAMA4, 1, 12, 0.5, (2, 3))])
def test_moe_ffn_matches_reference(arch, B, S, cf, tie):
    cfg, p, mod = _layer(arch, 11, tie)
    x = np.random.default_rng(12).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, want_aux = jl.moe_ffn(p, jnp.asarray(x), cfg, cf)
    tcfg = get_config(arch, smoke=True)
    got, aux = tl.moe_ffn(mod, _t(x), tcfg, cf)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    assert abs(aux.item() - float(want_aux)) < TOL
    assert aux.dtype == torch.float32
    # the case is what it says: pairs dropped at C, or the tie taken
    # by the lower expert, as jax.lax.top_k takes it
    _, (se, st, sw, pos, keep), probs, topi = tl._moe_dispatch_block(
        _t(x).reshape(-1, cfg.d_model), mod, tcfg, cf)
    if cf < 1:
        assert not keep.all()
    if tie is not None:
        a, b = tie
        assert bool((topi == a).any())
        rows = (topi == b).any(-1)     # b only ever beside a (top-1: never)
        assert bool((topi[rows] == a).any(-1).all())
        _, jtop = jax.lax.top_k(jnp.asarray(probs.detach().numpy()),
                                tcfg.top_k)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(jtop))


def test_moe_gradients_match_reference():
    """Gradients of ``moe_ffn``'s output and aux as one loss, through the
    router's sort and the dispatch's index_put and index_add, against
    ``jax.grad`` (a capacity-overflow case: dropped pairs take none),
    within 1e-5 of each gradient's largest magnitude (the router's sum
    the loss over all 32 x 256 outputs, up to ~20)."""
    cfg, p, mod = _layer(PHI, 13)
    x = np.random.default_rng(14).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(15).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jl.moe_ffn(p, x, cfg, 0.75)
        return jnp.sum(y * w) + aux

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y, aux = tl.moe_ffn(mod, xt, get_config(PHI, smoke=True), 0.75)
    params = [mod.router, mod.wi, mod.wg, mod.wo, xt]
    grads = torch.autograd.grad((y * _t(w)).sum() + aux, params)
    for got, want, name in zip(grads, (gp["router"]["w"], gp["wi"],
                                       gp["wg"], gp["wo"], gx),
                               ("router", "wi", "wg", "wo", "x")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=name)


def _leaf(tree, name: str, pattern_len: int):
    """The reference leaf of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    j, path = int(parts[1]), parts[2:]
    node = tree["groups"][f"l{j % pattern_len}"]
    for part in path:
        node = node[part]
    if path[0] == "ffn" and isinstance(node, dict):
        node = node["w"]
    return node[j // pattern_len]


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_lm_loss_gradients_match_reference(arch):
    """A whole MoE model's loss (the aux at weight 0.01 included) and
    every parameter's gradient, leaf by leaf, within 1e-5."""
    jcfg = jget(arch, smoke=True)
    params = japi.init_model(jax.random.key(16), jcfg)
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config(arch, smoke=True)
    model = backbone.params_from_jax(tree, cfg)
    batch = api.make_train_batch(np.random.default_rng(17), cfg, 2, 32)
    batch["labels"][1, :3] = -1
    loss, g = jax.jit(jax.value_and_grad(japi.train_loss),
                      static_argnums=(1, 3))(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    got = api.train_loss(model, cfg, {k: _t(v) for k, v in batch.items()})
    assert abs(got.item() - float(loss)) < TOL
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, list(model.parameters()))
    g = jax.tree.map(np.asarray, g)
    for name, a in zip(names, grads):
        np.testing.assert_allclose(a.numpy(), _leaf(g, name,
                                                    len(cfg.layer_pattern)),
                                   rtol=0, atol=TOL, err_msg=name)


def test_forward_returns_the_aux_loss():
    """``forward`` returns (logits, aux): the MoE layers' summed Switch
    losses, 0 for a dense model; the reference's aux within 1e-5."""
    jcfg = jget(PHI, smoke=True)
    params = japi.init_model(jax.random.key(18), jcfg)
    cfg = get_config(PHI, smoke=True)
    model = backbone.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(19).integers(0, cfg.vocab, (2, 16))
    from repro.models import backbone as jbb
    _, want = jbb.forward(params, jcfg, jnp.asarray(toks), remat=False)
    _, aux = backbone.forward(model, cfg, _t(toks))
    assert aux.item() > 0 and abs(aux.item() - float(want)) < TOL
    dense = get_config("smollm-360m", smoke=True)
    dm = api.init_model(dense, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert backbone.forward(dm, dense, _t(toks))[1].item() == 0.0


S, B, STEPS, SEED, LR = 2048, 1, 3, 0, 1e-2


def test_driver_steps_match_the_reference_step():
    """3 ``run_lm`` steps of phi3.5-moe smoke (S = 2,048: every layer on
    the flash route, then the MoE) against the reference's unsharded
    step, ``jax.value_and_grad(api.train_loss)`` and ``adam``, as its
    driver builds it (whose sharded form fails on this tree, ROADMAP
    C-ref-4): losses within 1e-4."""
    cfg = jget(PHI, smoke=True)
    params = japi.init_model(jax.random.key(SEED), cfg)
    tree = jax.tree.map(np.asarray, params)
    opt = jopt.adam(LR)

    @jax.jit
    def step(p, o, tokens, labels):
        loss, g = jax.value_and_grad(japi.train_loss)(
            p, cfg, {"tokens": tokens, "labels": labels}, remat=False)
        p, o = opt.update(g, o, p)
        return p, o, loss

    stream = jtokens(SEED, cfg.vocab, B, S + 1)
    p, o, want = params, opt.init(params), []
    for _ in range(STEPS):
        tok = next(stream)
        p, o, loss = step(p, o, jnp.asarray(tok[:, :-1]),
                          jnp.asarray(tok[:, 1:]))
        want.append(float(loss))
    args = build_parser().parse_args(
        ["--arch", PHI, "--smoke", "--seq-len", str(S), "--batch-per-worker",
         str(B), "--steps", str(STEPS), "--seed", str(SEED), "--lr", str(LR),
         "--device", "cpu"])
    tcfg = get_config(PHI, smoke=True)
    out = run_lm(args, model=backbone.params_from_jax(tree, tcfg))
    got = [r["loss"] for r in out["metrics"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_params_from_jax_moe_layout():
    cfg = get_config(LLAMA4, smoke=True)
    tree = jax.tree.map(np.asarray, japi.init_model(jax.random.key(2),
                                                    jget(LLAMA4, smoke=True)))
    model = backbone.params_from_jax(tree, cfg)
    ffn = model.layers[0].ffn
    assert isinstance(ffn, tl.MoE) and ffn.shared is not None
    assert tuple(ffn.wi.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(ffn.wo.shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert tuple(ffn.router.shape) == (cfg.d_model, cfg.n_experts)
    n = sum(q.numel() for q in model.parameters())
    assert n == cfg.param_count() + cfg.d_model       # + final_norm
    init = backbone.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in init.named_parameters()] == \
        [(k, tuple(v.shape)) for k, v in model.named_parameters()]
