"""``models/scan_config.py``, ``kernels/ref.py`` and the DLRM's SGD
step on the CPU, against the JAX package's.

- ``scan_apply`` against the reference's (scanned and unrolled), and
  ``UNROLL`` growing the blockwise attention's key block and the plain
  scan's chunk as the reference's probes grow them;
- the oracles of ``kernels/ref.py`` against the reference's (1e-5);
- ``dlrm.train_step`` against the reference's for 3 steps on wdl-tiny
  and dcn-tiny (1e-6), with the consistency property of the reference's
  ``tests/test_consistency.py`` held on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DLRM_CONFIGS as J_DLRM
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.kernels import ref as jref
from repro.models import dlrm as jdlrm
from repro.models import scan_config as jscan
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import linear_scan as LS
from repro_torch.kernels import ref
from repro_torch.models import dlrm, scan_config
from repro_torch.models import layers as tl

STEPS, TOL = 3, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# scan_apply, kernels/ref.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("unroll", [False, True])
def test_scan_apply_matches_reference(unroll, monkeypatch):
    monkeypatch.setattr(jscan, "UNROLL", unroll)
    rng = np.random.default_rng(5)
    xs = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": [rng.standard_normal((4, 2, 3)).astype(np.float32)]}

    def body(np_mod):
        def f(h, x):
            h = h * 0.5 + x["a"] + x["b"][0].sum(0)
            return h, {"h": h, "sq": h * h}
        return f

    h0 = np.ones(3, np.float32)
    want_h, want_ys = jscan.scan_apply(body(jnp), jnp.asarray(h0),
                                       jax.tree.map(jnp.asarray, xs))
    got_h, got_ys = scan_config.scan_apply(
        body(torch), _t(h0), {"a": _t(xs["a"]), "b": [_t(xs["b"][0])]})
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-6)
    for k in ("h", "sq"):
        assert got_ys[k].shape == want_ys[k].shape == (4, 3)
        np.testing.assert_allclose(got_ys[k].numpy(), np.asarray(want_ys[k]),
                                   atol=1e-6)
    _, none = scan_config.scan_apply(lambda c, x: (c + x, None), _t(h0),
                                     _t(xs["a"]))
    _, jnone = jscan.scan_apply(lambda c, x: (c + x, None), jnp.asarray(h0),
                                jnp.asarray(xs["a"]))
    assert none is None and jnone is None
    assert scan_config.PROBE_INNER_STEPS == jscan.PROBE_INNER_STEPS
    assert scan_config.UNROLL is False


def test_unroll_grows_the_blocks_and_chunks_as_the_reference(monkeypatch):
    """Under UNROLL the blockwise attention's key block and the plain
    scan's chunk are S // PROBE_INNER_STEPS: the outputs stay within f32
    rounding of the default ones."""
    calls = []
    plain = tl.attention_blockwise

    def spy(*a, **kw):
        calls.append(a[-1])
        return plain(*a, **kw)

    monkeypatch.setattr(tl, "attention_blockwise", spy)
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((1, 8192, 1, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 8192, 1, 16)).astype(np.float32))
    base = tl.attention_flash(q, k, k, "local", 1024)
    monkeypatch.setattr(scan_config, "UNROLL", True)
    big = tl.attention_flash(q, k, k, "local", 1024)
    assert calls == [512, 1024]
    np.testing.assert_allclose(big.numpy(), base.numpy(), atol=1e-5)
    chunks = []
    monkeypatch.setattr(LS, "linear_scan_ref", lambda a, b, h0, c: (
        chunks.append(c), (b, h0))[1])
    from repro_torch.models import ssm
    a = torch.ones((1, 4096, 2))
    ssm.chunked_linear_scan(a, a, torch.zeros((1, 2)))
    monkeypatch.setattr(scan_config, "UNROLL", False)
    ssm.chunked_linear_scan(a, a, torch.zeros((1, 2)))
    assert chunks == [512, 256]


def test_kernel_refs_match_reference():
    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, (6, 5)).astype(np.int32)
    w = rng.random((6, 5)).astype(np.float32)
    for weights in (None, w):
        want = jref.pooled_lookup_ref(jnp.asarray(table), jnp.asarray(ids),
                                      None if weights is None
                                      else jnp.asarray(weights))
        got = ref.pooled_lookup_ref(_t(table), _t(ids), None if weights is None
                                    else _t(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)

    cost = rng.random((12, 5)).astype(np.float32)
    price = rng.random(5).astype(np.float32)
    un = rng.random(12) < 0.6
    for n in (5, 1):
        wj, wb = jref.auction_bids_ref(jnp.asarray(cost[:, :n]),
                                       jnp.asarray(price[:n]),
                                       jnp.asarray(un), 0.01)
        gj, gb = ref.auction_bids_ref(_t(cost[:, :n]), _t(price[:n]),
                                      _t(un), 0.01)
        assert gj.dtype == torch.int32 and gb.dtype == torch.float32
        np.testing.assert_array_equal(gj.numpy(), np.asarray(wj))
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6)

    q = rng.standard_normal((2, 24, 2, 3, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 24, 2, 16)).astype(np.float32)
    for causal, window in ((True, 0), (False, 0), (True, 5), (False, 7)):
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kv[0]),
                                        jnp.asarray(kv[1]), causal, window)
        got = ref.flash_attention_ref(_t(q), _t(kv[0]), _t(kv[1]), causal,
                                      window)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # B8's plain version is the same function where it applies
    out, _ = FA.flash_attention_ref(_t(q), _t(kv[0]), _t(kv[1]), True)
    np.testing.assert_allclose(out.numpy(), ref.flash_attention_ref(
        _t(q), _t(kv[0]), _t(kv[1])).numpy(), atol=TOL)


# --------------------------------------------------------------------------
# the DLRM's SGD step
# --------------------------------------------------------------------------
def _dlrm_batch(wl, rng, k):
    return {"sparse": wl.sample_batch(rng, k), "dense": wl.dense_batch(rng, k),
            "labels": wl.label_batch(rng, k)}


@pytest.mark.parametrize("kind", ["wdl-tiny", "dcn-tiny"])
def test_dlrm_train_step_matches_reference(kind):
    jcfg, cfg = J_DLRM[kind], DLRM_CONFIGS[kind]
    jwl = J_WORKLOADS[jcfg.workload]
    params = jdlrm.init_params(jax.random.key(0), jcfg, jwl)
    model = dlrm.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    before = [p.clone() for p in model.parameters()]
    rng = np.random.default_rng(8)
    jstep = jax.jit(jdlrm.train_step, static_argnums=(1,))
    for _ in range(STEPS):
        b = _dlrm_batch(WORKLOADS[cfg.workload], rng, 16)
        params, want = jstep(params, jcfg, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        model, got = dlrm.train_step(model, cfg, {k: _t(v)
                                                  for k, v in b.items()})
        assert abs(float(got) - float(want)) < 1e-6
    assert all(torch.equal(a, b) for a, b in zip(
        before, dlrm.params_from_jax(jax.tree.map(
            np.asarray, jdlrm.init_params(jax.random.key(0), jcfg, jwl)),
            cfg).parameters()))
    for g, w in zip(model.parameters(),
                    dlrm.params_from_jax(jax.tree.map(np.asarray, params),
                                         cfg).parameters()):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["wdl-tiny", "dfm-tiny", "dcn-tiny"])
def test_dispatch_permutation_invariance(kind, rng):
    """The paper's consistency claim on the port: permuting the batch
    (all dispatch does) leaves the gradients unchanged."""
    cfg = DLRM_CONFIGS[kind]
    wl = WORKLOADS[cfg.workload]
    model = dlrm.init_params(cfg, wl, torch.Generator().manual_seed(0),
                             "cpu").requires_grad_(True)
    b = _dlrm_batch(wl, rng, 32)
    perm = rng.permutation(32)

    def grads(s, d, l):
        loss = dlrm.bce_loss(model, _t(s), _t(d), _t(l))
        return torch.autograd.grad(loss, list(model.parameters()))

    g0 = grads(b["sparse"], b["dense"], b["labels"])
    g1 = grads(b["sparse"][perm], b["dense"][perm], b["labels"][perm])
    for a, c in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-6)


def test_full_training_run_identical():
    """Five SGD steps of a permuted stream against the stream as it
    came: the same final model."""
    cfg = DLRM_CONFIGS["wdl-tiny"]
    wl = WORKLOADS[cfg.workload]

    def train(permute: bool):
        model = dlrm.init_params(cfg, wl, torch.Generator().manual_seed(1),
                                 "cpu")
        r = np.random.default_rng(7)
        stream = wl.stream(123, 16)
        for _ in range(5):
            s, d, l = next(stream)
            if permute:
                p = r.permutation(16)
                s, d, l = s[p], d[p], l[p]
            model, _ = dlrm.train_step(model, cfg, {
                "sparse": _t(s), "dense": _t(d), "labels": _t(l)})
        return model

    for a, b in zip(train(False).parameters(), train(True).parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)
