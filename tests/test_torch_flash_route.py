"""B8's route rule on the CPU: which card kernel takes which inputs.

The bf16 forward runs on the tensor cores (``wgmma`` fed by TMA), which
read k and v by TMA boxes and q by 16-byte loads; f32 runs on the tensor
cores too, as split TF32 products (route ``tf32x3``), its split pass
reading q, k and v by threads through any strides.  The rule is a pure function of dtypes, hd and
each tensor's (shape, strides, address), so it is tested here without a
card, on CPU tensors' layouts.  The smoke LM's q, k and v, as they reach
B8, must meet the bf16 route's rule.  The autograd Function's backward
goes through :func:`flash_attention_backward`, which on the CPU is the
plain :func:`flash_attention_bwd`, exactly.  The backward's rule
(:func:`backward_route`: bf16 -> ``wgmma``, raising on a q, k or v that
TMA cannot read and copying such a dout; f32 -> ``tf32x3``, whose split
pass reads every view, copying none) and its row tiles
(:func:`stat_tiling`, the statistics' order held against the f32
route's row order r = s G + g) are tested here the same way.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as tf
from repro_torch.models import api, layers


def _layout(t):
    return tuple(t.shape), tuple(t.stride()), t.data_ptr()


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
])
def test_route_by_dtype(dtype, hd, route):
    assert tf.kernel_route((dtype,) * 3, hd) == route


@pytest.mark.parametrize("dtypes,hd,err,match", [
    ((torch.float16,) * 3, 64, TypeError, "bf16 or f32"),
    ((torch.bfloat16, torch.float32, torch.float32), 64, TypeError,
     "one dtype"),
    ((torch.float64,) * 3, 64, TypeError, "bf16 or f32"),
    ((torch.bfloat16,) * 3, 48, ValueError, "hd in"),
    ((torch.float32,) * 3, 256, ValueError, "hd in"),
])
def test_route_raises_on_what_no_kernel_takes(dtypes, hd, err, match):
    with pytest.raises(err, match=match):
        tf.kernel_route(dtypes, hd)


def _views():
    base = torch.zeros((2, 64, 3, 4 * 72), dtype=torch.bfloat16)
    fused = torch.zeros((2, 64, 3, 5, 64), dtype=torch.bfloat16)
    return {
        "contiguous": (torch.zeros((2, 64, 3, 64), dtype=torch.bfloat16),
                       None),
        "fused projection (unit inner stride)": (fused[:, :, :, 3], None),
        "padded rows of 72": (base[..., :64], None),
        "length-1 dims with odd strides": (
            torch.zeros((1, 64, 1, 67), dtype=torch.bfloat16)[..., :64]
            .as_strided((1, 64, 1, 64), (5, 64, 3, 1)), None),
        "transposed (inner stride 64)": (
            torch.zeros((2, 3, 64, 64), dtype=torch.bfloat16)
            .transpose(-1, -2), "innermost stride"),
        "rows of 68 (136 bytes)": (
            torch.zeros((2, 64, 3, 68), dtype=torch.bfloat16)[..., :64],
            "multiple of 16 bytes"),
        "misaligned by 2 bytes": (
            torch.zeros(2 * 64 * 3 * 64 + 1, dtype=torch.bfloat16)[1:]
            .view(2, 64, 3, 64), "16-byte aligned"),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_tma_layout_rule(name):
    t, fault = _views()[name]
    got = tf.tma_layout_fault(t.shape, t.stride(), t.data_ptr())
    if fault is None:
        assert got is None
    else:
        assert fault in got


def test_bf16_route_raises_on_a_view_tma_cannot_take():
    q = torch.zeros((1, 64, 3, 1, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 3, 64, 64), dtype=torch.bfloat16).transpose(1, 2)
    k = k.transpose(-1, -2)                  # innermost stride 64
    good = torch.zeros((1, 64, 3, 64), dtype=torch.bfloat16)
    assert tf.kernel_route((torch.bfloat16,) * 3, 64,
                           [_layout(q), _layout(good), _layout(good)]) \
        == "wgmma"
    with pytest.raises(ValueError, match="bf16 route cannot read k"):
        tf.kernel_route((torch.bfloat16,) * 3, 64,
                        [_layout(q), _layout(k), _layout(good)])
    # f32 takes any strides
    assert tf.kernel_route((torch.float32,) * 3, 64,
                           [_layout(q), _layout(k), _layout(good)]) \
        == "tf32x3"


def test_tma_strides_fill_length_one_dims():
    t = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    assert tf._tma_strides(t) == (8, 64, 8, 1)


@pytest.mark.parametrize("arch", ["smollm-360m"])
def test_smoke_lm_qkv_meet_the_bf16_rule(arch, monkeypatch):
    """The model's q and k come out of ``rope`` and v out of an einsum:
    at S = 2,048 in bf16, all three reach B8 in a layout the bf16 route
    reads without a copy."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    seen = []
    plain = layers.flash_attn

    def spy(q, k, v, causal=True):
        seen.append((q, k, v))
        return plain(q, k, v, causal)

    monkeypatch.setattr(layers, "flash_attn", spy)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 2049)))
    with torch.no_grad():
        api.train_loss(model, cfg, {"tokens": tok[:, :-1],
                                    "labels": tok[:, 1:]})
    assert len(seen) == cfg.n_layers
    for q, k, v in seen:
        assert q.dtype == torch.bfloat16
        assert tf.kernel_route((q.dtype, k.dtype, v.dtype), q.shape[-1],
                               [_layout(t) for t in (q, k, v)]) == "wgmma"


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_backward_is_flash_attention_backward(causal, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 96, 2, 3, 32), (1, 96, 2, 32), (1, 96, 2, 32)))
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    calls = []
    routed = tf.flash_attention_backward

    def spy(*a):
        calls.append(1)
        return routed(*a)

    monkeypatch.setattr(tf, "flash_attention_backward", spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad((tf.flash_attn(*leaves, causal) * w).sum(),
                              leaves)
    assert calls == [1]
    out, lse = tf.flash_attention(q, k, v, causal)
    want = tf.flash_attention_bwd(q, k, v, out, lse, w, causal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n0 = dict(tf.LAUNCHES)
    again = tf.flash_attention_backward(q, k, v, out, lse, w, causal)
    assert tf.LAUNCHES == n0            # the CPU runs the plain version
    for a, b in zip(again, want):
        assert torch.equal(a, b)


# ---- the backward's route rule and its statistics' order

def _bwd_layouts(dtype, bad=None, view=None):
    """(shape, strides, data_ptr) of q, k, v and dout, contiguous but for
    ``bad``, which gets ``view``'s layout."""
    ts = {"q": torch.zeros((1, 64, 3, 1, 64), dtype=dtype),
          "k": torch.zeros((1, 64, 3, 64), dtype=dtype),
          "v": torch.zeros((1, 64, 3, 64), dtype=dtype),
          "dout": torch.zeros((1, 64, 3, 1, 64), dtype=dtype)}
    if bad is not None:
        ts[bad] = view
    return [_layout(ts[n]) for n in ("q", "k", "v", "dout")]


def _transposed(dtype, nd):
    """A view whose innermost stride is not 1, of q's (nd 5) or k's
    shape."""
    t = torch.zeros((1, 3, 64, 64), dtype=dtype).transpose(-1, -2)
    t = t.transpose(1, 2)                      # (1, 64, 3, 64)
    return t.unsqueeze(3) if nd == 5 else t


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_backward_route_by_dtype(dtype, route, hd):
    assert tf.backward_route((dtype,) * 5, hd, _bwd_layouts(dtype)) == \
        (route, (False,) * 4)


@pytest.mark.parametrize("dtypes,match", [
    ((torch.bfloat16,) * 3 + (torch.float32, torch.bfloat16), "one dtype"),
    ((torch.float16,) * 5, "bf16 or f32"),
])
def test_backward_route_raises_on_dtypes(dtypes, match):
    with pytest.raises(TypeError, match=match):
        tf.backward_route(dtypes, 64, _bwd_layouts(torch.bfloat16))


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_backward_bf16_raises_on_a_qkv_view_tma_cannot_take(name):
    """The forward took q, k and v as they are: a view it would refuse
    never reaches the backward, which refuses it too."""
    view = _transposed(torch.bfloat16, 5 if name == "q" else 4)
    with pytest.raises(ValueError, match=f"bf16 route cannot read {name}"):
        tf.backward_route((torch.bfloat16,) * 5, 64,
                          _bwd_layouts(torch.bfloat16, name, view))


@pytest.mark.parametrize("view", ["transposed", "rows of 68",
                                  "misaligned"])
def test_backward_bf16_copies_a_dout_tma_cannot_take(view):
    dt = torch.bfloat16
    t = {"transposed": _transposed(dt, 5),
         "rows of 68": torch.zeros((1, 64, 3, 1, 68), dtype=dt)[..., :64],
         "misaligned": torch.zeros(64 * 3 * 64 + 1, dtype=dt)[1:]
         .view(1, 64, 3, 1, 64)}[view]
    assert tf.backward_route((dt,) * 5, 64, _bwd_layouts(dt, "dout", t)) \
        == ("wgmma", (False, False, False, True))


@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_backward_f32_copies_any_view_it_cannot_read(name):
    """f32's split pass reads q, k, v and dout by threads through any
    strides (TMA reads only the split's scratch), so no view is one it
    cannot read: an innermost stride of 64 and rows of 68 floats (272
    bytes) are both read as they are, nothing copied."""
    dt, nd = torch.float32, 5 if name in ("q", "dout") else 4
    got = tf.backward_route((dt,) * 5, 64,
                            _bwd_layouts(dt, name, _transposed(dt, nd)))
    assert got == ("tf32x3", (False,) * 4)
    padded = torch.zeros((1, 64, 3, 68), dtype=dt)[..., :64]
    padded = padded.unsqueeze(3) if nd == 5 else padded
    assert tf.backward_route((dt,) * 5, 64, _bwd_layouts(dt, name, padded)) \
        == ("tf32x3", (False,) * 4)


@pytest.mark.parametrize("Sq,G,want", [
    (2048, 3, (21, 3, 1, 98)),      # smollm: 63 rows a tile
    (2048, 4, (16, 4, 1, 128)),     # phi3.5-moe, pixtral
    (300, 1, (64, 1, 1, 5)),
    (40, 65, (1, 64, 2, 80)),       # G > 64: two head blocks a position
    (7, 64, (1, 64, 1, 7)),
])
def test_stat_tiling(Sq, G, want):
    P, Gb, HB, NT = tf.stat_tiling(Sq, G)
    assert (P, Gb, HB, NT) == want
    assert P * Gb <= tf.ROW_TILE and HB * Gb >= G
    assert NT == -(-Sq // P) * HB


def _stat_lse_index(B, Sq, KV, G):
    """For each pair of the bf16 backward's statistics scratch, in its
    order (:func:`flash_attn.stat_tiling`), the index into lse (B, KV, G,
    Sq) flattened, or -1 for a pad row (where the kernel writes (+inf,
    0)); the kernel's own decode, written out."""
    P, Gb, HB, NT = tf.stat_tiling(Sq, G)
    tile = torch.arange(NT)[:, None]
    j = torch.arange(tf.ROW_TILE)[None, :]
    s = tile // HB * P + j // Gb
    g = tile % HB * Gb + j % Gb
    valid = (j < P * Gb) & (s < Sq) & (g < G)
    bkv = torch.arange(B * KV)[:, None, None]
    idx = (bkv * G + g) * Sq + s
    return torch.where(valid, idx, -1).reshape(-1)


def _stat_index(b, h, r, KV, G, Sq):
    """lse's flat index of row r = s G + g of the (b, kv) pair: the row
    order of the f32 route's statistics."""
    return ((b * KV + h) * G + r % G) * Sq + r // G


@pytest.mark.parametrize("B,Sq,KV,G", [(2, 300, 2, 3), (1, 2048, 8, 4),
                                       (2, 100, 3, 1), (1, 130, 2, 64),
                                       (1, 9, 2, 65), (3, 5, 1, 2)])
def test_stat_order_is_stat_index_order(B, Sq, KV, G):
    """The scratch holds every row's statistics once; read in its order,
    a (b, kv) pair's valid slots are ``stat_index``'s rows r = 0, 1, ...
    (for G > 64 position by position, a head block at a time), and pads
    fill each tile past its P Gb rows and past the last position."""
    P, Gb, HB, NT = tf.stat_tiling(Sq, G)
    idx = _stat_lse_index(B, Sq, KV, G)
    assert idx.shape == (B * KV * NT * tf.ROW_TILE,)
    valid = idx[idx >= 0]
    assert torch.equal(valid.sort().values, torch.arange(B * KV * G * Sq))
    per = idx.view(B * KV, NT, tf.ROW_TILE)
    assert bool((per[:, :, P * Gb:] == -1).all())
    for b in range(B):
        for h in range(KV):
            got = per[b * KV + h]
            got = got[got >= 0].tolist()
            if G <= tf.ROW_TILE:
                rows = range(Sq * G)
            else:
                rows = [s * G + g for s in range(Sq)
                        for hb in range(HB)
                        for g in range(hb * Gb, min(G, (hb + 1) * Gb))]
            assert got == [_stat_index(b, h, r, KV, G, Sq) for r in rows]
