"""The SSM mixers on the CPU against the JAX package's ``models/ssm.py``.

``causal_conv1d`` and ``conv_step``; ``chunked_linear_scan`` at S <=
chunk (one associative scan) and at S a multiple of a small chunk (the
loop over chunks), its autograd Function (the plain reverse scan as its
backward) against autograd through the plain forward and against
``jax.grad`` of the reference's scan; ``mamba_block``, ``mamba_step``,
``rglru_block`` and ``rglru_step`` at the smoke widths with the
reference's ``init_mamba`` and ``init_rglru`` weights carried across;
the wrappers' checks and the kernels' block shape.

Inputs are numpy draws of one seed, all in f32.  Tolerances: the scan
within 2e-6 of max |h| (its plain version is a doubling scan, XLA's
associative scan another tree; with every a in (0, 1) a rounding error
decays along the sequence, and each side stays within 2e-7 of an f64
sequential scan at S 2,048), its gradients within 2e-6 of their max;
block outputs within 1e-5 absolute (magnitude ~1: f32 sums of up to
d_inner products in another order, and softplus, sigmoid and exp in
two libraries).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import linear_scan as LS
from repro_torch.models import ssm

TOL = 1e-5
SCAN_TOL = 2e-6      # relative to max |h| (or the gradient's max)


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scan_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal(shape[:1] + shape[2:]).astype(np.float32)
    return a, b, h0


def _close(got, want, tol=SCAN_TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("bias", [False, True])
def test_causal_conv1d(bias):
    x, w, b = _x(0, 2, 24, 48), _x(1, 4, 48, scale=0.2), _x(2, 48)
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b) if bias else None)
    got = ssm.causal_conv1d(_t(x), _t(w), _t(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_conv_step(bias):
    state, x_t = _x(3, 2, 3, 48), _x(4, 2, 48)
    w, b = _x(5, 4, 48, scale=0.2), _x(6, 48)
    out, new = jssm.conv_step(jnp.asarray(state), jnp.asarray(x_t),
                              jnp.asarray(w), jnp.asarray(b) if bias else None)
    got, got_new = ssm.conv_step(_t(state), _t(x_t), _t(w),
                                 _t(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got_new.numpy(), np.asarray(new))


def test_conv_step_continues_the_causal_conv():
    """Stepping a zero window through the sequence gives the causal
    conv's rows."""
    x, w = _x(7, 2, 10, 16), _x(8, 4, 16, scale=0.2)
    full = ssm.causal_conv1d(_t(x), _t(w))
    state = torch.zeros((2, 3, 16))
    for t in range(10):
        out, state = ssm.conv_step(state, _t(x[:, t]), _t(w))
        np.testing.assert_allclose(out.numpy(), full[:, t].numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("shape,chunk", [
    ((2, 48, 8, 4), None),        # S <= chunk: one associative scan
    ((2, 256, 16), None),         # S == chunk: still one scan
    ((2, 96, 8, 4), 16),          # the loop over 6 chunks
    ((1, 128, 32), 32)])
def test_chunked_linear_scan(shape, chunk):
    a, b, h0 = _scan_inputs(len(shape) + shape[1], shape)
    n0 = dict(LS.LAUNCHES)
    wh, wl = jssm.chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(h0), chunk=chunk)
    h, hl = ssm.chunked_linear_scan(_t(a), _t(b), _t(h0), chunk=chunk)
    assert LS.LAUNCHES == n0                        # CPU: the plain version
    _close(h.numpy(), wh, what="h")
    _close(hl.numpy(), wl, what="h_last")


def test_scan_is_the_sequential_recurrence():
    """The plain scan against the recurrence run step by step in f64."""
    a, b, h0 = _scan_inputs(9, (2, 300, 6))
    h, hl = LS.linear_scan_ref(_t(a), _t(b), _t(h0), chunk=32)
    want, cur = np.zeros(a.shape), h0.astype(np.float64)
    for t in range(a.shape[1]):
        cur = a[:, t] * cur + b[:, t]
        want[:, t] = cur
    _close(h.numpy(), want, what="h")
    _close(hl.numpy(), want[:, -1], what="h_last")


def _loss_weights(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[:1] + shape[2:]).astype(np.float32))


@pytest.mark.parametrize("shape,chunk", [((2, 64, 12), 16),
                                         ((1, 40, 5), 256)])
def test_scan_function_gradients(shape, chunk):
    """``scan``'s plain backward against autograd through the plain
    forward and against ``jax.grad`` of the reference's scan, for a loss
    that reads both h and h_last."""
    a, b, h0 = _scan_inputs(11, shape)
    wh, wl = _loss_weights(12, shape)

    def jloss(a_, b_, h0_):
        h, hl = jssm.chunked_linear_scan(a_, b_, h0_, chunk=chunk)
        return jnp.sum(h * wh) + jnp.sum(hl * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, h0)))
    grads = {}
    for route in ("function", "autograd"):
        ta, tb, th = (_t(x).requires_grad_() for x in (a, b, h0))
        fn = LS.scan if route == "function" else LS.linear_scan_ref
        h, hl = fn(ta, tb, th, chunk)
        ((h * _t(wh)).sum() + (hl * _t(wl)).sum()).backward()
        grads[route] = (ta.grad, tb.grad, th.grad)
    for name, w, f, g in zip(("da", "db", "dh0"), want, grads["function"],
                             grads["autograd"]):
        _close(f.numpy(), w, what=f"{name} vs jax.grad")
        _close(f.numpy(), g.numpy(), what=f"{name} vs autograd")


def test_scan_backward_without_h_last():
    """A loss that reads only h (the blocks' case): autograd hands the
    Function no gradient for h_last."""
    a, b, h0 = _scan_inputs(13, (2, 32, 4))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    h, _ = LS.scan(ta, tb, _t(h0))
    h.sum().backward()
    da, db, _ = LS.linear_scan_bwd_ref(_t(a), h.detach(), _t(h0),
                                       torch.ones_like(h))
    _close(ta.grad.numpy(), da.numpy())
    _close(tb.grad.numpy(), db.numpy())


@pytest.mark.parametrize("bad,match", [
    (lambda a, b, h0: (a.double(), b, h0), "f32"),
    (lambda a, b, h0: (a[0], b[0], h0), r"\(B, S, C\)"),
    (lambda a, b, h0: (a, b[:, :3], h0), "differs"),
    (lambda a, b, h0: (a, b, h0[:, :2]), "must be"),
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, match):
    a, b, h0 = map(_t, _scan_inputs(0, (2, 8, 4)))
    with pytest.raises((TypeError, ValueError), match=match):
        LS.linear_scan(*bad(a, b, h0))


def test_block_warps():
    """32 warps a block (long tiles) while the grid has fewer than four
    blocks a SM (RG-LRU's 80 at B 1), 8 when it has more (Mamba's 4,096
    at full width)."""
    assert LS.block_warps(80, 132) == 32
    assert LS.block_warps(527, 132) == 32
    assert LS.block_warps(528, 132) == 8
    assert LS.block_warps(4096, 132) == 8


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------
def _mamba(seed=0):
    cfg = jget("falcon-mamba-7b", smoke=True)
    p = jssm.init_mamba(jax.random.key(seed), cfg, jnp.float32)
    mod = ssm.Mamba(**{n: _t(p[n]["w"] if n in ssm.Mamba.LINEARS else p[n])
                       for n in ssm.Mamba.LEAVES})
    return cfg, p, mod


def _rglru(seed=0):
    cfg = jget("recurrentgemma-2b", smoke=True)
    p = jssm.init_rglru(jax.random.key(seed), cfg, jnp.float32)
    mod = ssm.RGLRU(**{n: _t(p[n]["w"] if n in ssm.RGLRU.LINEARS else p[n])
                       for n in ssm.RGLRU.LEAVES})
    return cfg, p, mod


@pytest.mark.parametrize("S", [48, 512])
def test_mamba_block(S):
    """S 48 takes one associative scan, S 512 two chunks of 256."""
    cfg, p, mod = _mamba()
    x = _x(20, 2, S, cfg.d_model)
    want = jssm.mamba_block(p, jnp.asarray(x), cfg)
    got = ssm.mamba_block(mod, _t(x), get_config("falcon-mamba-7b",
                                                 smoke=True))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("S", [48, 512])
def test_rglru_block(S):
    cfg, p, mod = _rglru()
    x = _x(21, 2, S, cfg.d_model)
    want = jssm.rglru_block(p, jnp.asarray(x), cfg)
    got = ssm.rglru_block(mod, _t(x), get_config("recurrentgemma-2b",
                                                 smoke=True))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_steps_match_reference_and_write_in_place(kind):
    """8 decode steps from a zero cache: outputs and both cache entries
    against the reference's step, the port's cache tensors written in
    place; and the steps equal the port's own block over the sequence."""
    cfg, p, mod = (_mamba if kind == "mamba" else _rglru)(seed=1)
    tcfg = get_config(cfg.name.removesuffix("-smoke"), smoke=True)
    jstep, step = ((jssm.mamba_step, ssm.mamba_step) if kind == "mamba"
                   else (jssm.rglru_step, ssm.rglru_step))
    jinit, init = ((jssm.init_mamba_cache, ssm.init_mamba_cache)
                   if kind == "mamba" else
                   (jssm.init_rglru_cache, ssm.init_rglru_cache))
    x = _x(22, 2, 8, cfg.d_model)
    jcache = jinit(cfg, 2, jnp.float32)
    cache = init(tcfg, 2, torch.float32, "cpu")
    ids = {k: v.data_ptr() for k, v in cache.items()}
    outs = []
    with torch.no_grad():
        for t in range(8):
            want, jcache = jstep(p, jnp.asarray(x[:, t:t + 1]), jcache, cfg)
            got, cache = step(mod, _t(x[:, t:t + 1]), cache, tcfg)
            outs.append(got)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL, err_msg=str(t))
            for k in cache:
                np.testing.assert_allclose(cache[k].numpy(),
                                           np.asarray(jcache[k]), rtol=0,
                                           atol=TOL, err_msg=f"{k} {t}")
        block = (ssm.mamba_block if kind == "mamba"
                 else ssm.rglru_block)(mod, _t(x), tcfg)
    assert {k: v.data_ptr() for k, v in cache.items()} == ids
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), block.numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_init_matches_the_reference_distributions(kind):
    """Shapes, dtypes and the deterministic leaves as the reference's;
    RG-LRU's ``a = sigmoid(Lambda) ** 8`` within [0.9, 0.999]."""
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-2b"
    jcfg = dataclasses.replace(jget(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    jinit = jssm.init_mamba if kind == "mamba" else jssm.init_rglru
    init = ssm.init_mamba if kind == "mamba" else ssm.init_rglru
    want = jinit(jax.random.key(0), jcfg, jnp.bfloat16)
    mod = init(cfg, torch.bfloat16, generator=torch.Generator().manual_seed(0),
               device="cpu")
    cls = type(mod)
    for name in cls.LEAVES:
        w = want[name]["w"] if name in cls.LINEARS else want[name]
        got = getattr(mod, name)
        assert tuple(got.shape) == w.shape, name
        assert str(got.dtype).split(".")[-1] == str(w.dtype), name
    if kind == "mamba":
        # log(1..N) in two libraries: one ulp apart at one of the 16
        for name, rtol in (("A_log", 2e-7), ("D", 0), ("dt_bias", 0),
                           ("conv_b", 0)):
            np.testing.assert_allclose(
                getattr(mod, name).detach().float().numpy(),
                np.asarray(want[name], np.float32), rtol=rtol, atol=0,
                err_msg=name)
    else:
        a = torch.sigmoid(mod.Lambda.detach()) ** ssm.RG_C
        assert 0.9 - 1e-5 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-5
