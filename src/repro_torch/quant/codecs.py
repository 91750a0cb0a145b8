"""Quantization codecs for the embedding wire paths (DQRM-style).

The counterpart of the JAX package's ``quant/codecs.py``.  A codec maps
a float32 row of ``E`` elements to

  * ``fp16``  — a dtype cast, 2 bytes/elem, no side metadata;
  * ``int8``  — per-group affine codes ``q = round((x - zp) / scale)``
    in [0, 255], 1 byte/elem;
  * ``int4``  — the same affine map into [0, 15], two codes packed per
    byte.

A *group* is the whole row (per-row, the default) or ``block``
consecutive elements (``"int8:64"``).  ``zp = min(group)``, ``scale =
(max - min) / levels`` with zero-range groups snapped to scale 1, so a
constant group (PAD fill rows included) round-trips exactly.

The host-side parts (the :class:`Codec` vocabulary, byte accounting and
the per-link policy) are numpy and pure Python, copied line for line.
The tensor parts are PyTorch and take the forms the reference's
functions take under ``jax.jit``, which is how every one of its drivers
calls them, so that codes do not flip at group boundaries:

  * the scale is ``(hi - lo)`` times the f32 reciprocal of ``levels``
    (XLA rewrites the division by a constant into that product);
  * codes divide by the expanded scale and round half to even;
  * the dequant ``codes * scale + zp`` is one fused multiply-add.
    PyTorch offers no FMA on either device, so :func:`dequantize_rows`
    forms the product (exact in f64: an 8-bit code times a 24-bit
    scale) and the sum in f64 and rounds once to f32.

All tensor functions accept any ``(..., E)`` shape, grouping over the
trailing dim.  ``codec=None`` everywhere means fp32: callers keep that
path untouched.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Codec", "get_codec", "codec_name", "quantize_rows", "dequantize_rows",
    "fake_quant", "ste", "quantize_with_feedback", "pack_int4",
    "unpack_int4", "wire_row_bytes", "meta_row_bytes", "row_wire_bytes",
    "resolve_link_codecs", "CODEC_NAMES",
]

CODEC_NAMES = ("fp16", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire codec: bit width + scale/zero-point group size."""

    kind: str                 # "fp16" | "int8" | "int4"
    block: int | None = None  # elems per scale group (None = whole row)

    def __post_init__(self):
        if self.kind not in CODEC_NAMES:
            raise ValueError(f"unknown codec kind {self.kind!r}; "
                             f"expected one of {CODEC_NAMES}")
        if self.block is not None and self.block < 1:
            raise ValueError(f"codec block must be >= 1, got {self.block}")
        if self.kind == "fp16" and self.block is not None:
            raise ValueError("fp16 is a dtype cast; it has no scale groups")

    @property
    def bits(self) -> int:
        return {"fp16": 16, "int8": 8, "int4": 4}[self.kind]

    @property
    def levels(self) -> int:
        """Top code of the affine range (0..levels)."""
        return (1 << self.bits) - 1 if self.kind != "fp16" else 0

    @property
    def name(self) -> str:
        return self.kind if self.block is None else f"{self.kind}:{self.block}"


def get_codec(spec) -> Codec | None:
    """Resolve ``None`` / ``"none"`` / ``"int8"`` / ``"int4:32"`` / Codec."""
    if spec is None or isinstance(spec, Codec):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "none", "fp32", "float32"):
        return None
    kind, _, blk = s.partition(":")
    return Codec(kind, int(blk) if blk else None)


def codec_name(spec) -> str:
    c = get_codec(spec)
    return "fp32" if c is None else c.name


# --------------------------------------------------------------------------
# byte accounting (host-side, pure python — the cost layer's vocabulary)
# --------------------------------------------------------------------------
def _groups(elems: int, codec: Codec) -> int:
    if codec.block is None:
        return 1
    return -(-elems // codec.block)


def wire_row_bytes(elems: int, codec) -> int:
    """Payload code bytes for one ``elems``-wide row (no metadata)."""
    c = get_codec(codec)
    if c is None:
        return 4 * elems
    if c.kind == "fp16":
        return 2 * elems
    if c.kind == "int8":
        return elems
    return (elems + 1) // 2          # int4: two codes per byte


def meta_row_bytes(elems: int, codec) -> int:
    """Scale + zero-point side-channel bytes per row (fp32 pair/group)."""
    c = get_codec(codec)
    if c is None or c.kind == "fp16":
        return 0
    return 8 * _groups(elems, c)


def row_wire_bytes(elems: int, codec) -> int:
    """Payload + metadata — what the link actually carries per row."""
    return wire_row_bytes(elems, codec) + meta_row_bytes(elems, codec)


def resolve_link_codecs(policy: str, bandwidths, codec=None,
                        fast="fp16") -> np.ndarray | None:
    """Per-link codec names from a policy over link bandwidths.

    ``"uniform"`` tags every link with ``codec`` (None -> no codecs at
    all).  ``"bandwidth"`` splits at the median: links at or above it
    afford the ``fast`` codec (fp16), slower edge links drop to
    ``codec`` (default int4) — the heterogeneous-width scenario that
    reshapes Alg.-1 dispatch.  ``bandwidths`` may be (n,) or (n, n_ps);
    the result matches its shape (dtype object, entries are codec
    names).
    """
    bw = np.asarray(bandwidths, np.float64)
    if policy == "uniform":
        if codec is None:
            return None
        return np.full(bw.shape, codec_name(codec), object)
    if policy != "bandwidth":
        raise ValueError(f"unknown codec policy {policy!r}")
    slow = codec_name(codec if codec is not None else "int4")
    out = np.where(bw >= np.median(bw), codec_name(fast), slow)
    return out.astype(object)


# --------------------------------------------------------------------------
# quantize / dequantize (PyTorch, trailing-dim groups)
# --------------------------------------------------------------------------
def group_size(E: int, codec: Codec) -> int:
    """Elements per scale group of an ``E``-wide row (the last group of
    a block codec may be partial)."""
    return E if codec.block is None else min(codec.block, E)


def inv_levels(codec: Codec) -> float:
    """``1 / levels`` rounded to f32, as XLA folds the constant."""
    return float(np.float32(1.0) / np.float32(codec.levels))


def _grouped(x: torch.Tensor, B: int, fill: float = 0.0) -> torch.Tensor:
    """(..., E) -> (..., G, B), the pad tail of a partial terminal group
    set to ``fill`` (a copy only when there is a tail)."""
    E = x.shape[-1]
    pad = (-E) % B
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)
    return x.reshape(x.shape[:-1] + ((E + pad) // B, B))


def _ungrouped(g: torch.Tensor, E: int) -> torch.Tensor:
    """(..., G, B) -> (..., E), dropping the pad tail."""
    return g.reshape(g.shape[:-2] + (g.shape[-2] * g.shape[-1],))[
        ..., :E].contiguous()


def _group_bounds(x: torch.Tensor, codec: Codec, zero_sign: bool):
    """Per-group (lo, hi) of ``x`` (..., E), the pad tail of a partial
    terminal group excluded.  With ``zero_sign`` a zero minimum is -0
    where the group holds a -0, as the reference's ``min`` orders -0
    below +0 (``amin`` picks between them by its reduction order); it
    keeps every code +0.  Without it the zero's sign is ``amin``'s, which
    changes no dequantized value.  The sign of a zero ``hi`` changes no
    output."""
    B = group_size(x.shape[-1], codec)
    g = _grouped(x, B, float("inf"))
    lo = g.amin(dim=-1)
    if zero_sign:
        lo = torch.where((lo == 0) & torch.signbit(g).any(dim=-1), -0.0, lo)
    hi = _grouped(x, B, float("-inf")).amax(dim=-1)
    return lo, hi, B


def _quantize(x: torch.Tensor, c: Codec, zero_sign: bool):
    """:func:`quantize_rows` for a resolved codec; ``zero_sign`` as in
    :func:`_group_bounds`."""
    x = x.float()
    if c.kind == "fp16":
        one = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                         device=x.device)
        return x.half(), one, torch.zeros_like(one)
    E = x.shape[-1]
    lo, hi, B = _group_bounds(x, c, zero_sign)
    scale = (hi - lo) * inv_levels(c)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = _grouped(x, B) - lo[..., None]
    q.div_(scale[..., None]).round_().clamp_(0, c.levels)
    return _ungrouped(q, E), scale, lo


def quantize_rows(x: torch.Tensor, codec):
    """x (..., E) float -> (codes, scale, zp).

    fp16: ``codes`` is the fp16 cast; scale/zp are (..., 1) 1/0
    placeholders so every codec shares the ``codes * scale + zp``
    dequant.  int codecs: ``codes`` are f32-valued integers in [0,
    levels], scale/zp (..., G) f32 with zero-range groups snapped to
    scale 1 (constant groups round-trip exactly); the wire's bits, a
    zero zero-point's sign included, are the reference's.
    """
    c = get_codec(codec)
    if c is None:
        raise ValueError("quantize_rows needs a codec (None is the fp32 "
                         "identity path — do not call through it)")
    return _quantize(x, c, zero_sign=True)


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor | None,
                    zp: torch.Tensor | None, codec) -> torch.Tensor:
    """Invert :func:`quantize_rows`: ``codes * scale + zp`` (f32), the
    product and sum taken in f64 and rounded once, as one fused
    multiply-add would."""
    c = get_codec(codec)
    if c is None:
        raise ValueError("dequantize_rows needs a codec")
    if c.kind == "fp16":
        return codes.float()
    E = codes.shape[-1]
    t = _grouped(codes, group_size(E, c)).double()
    t.mul_(scale[..., None]).add_(zp[..., None])
    return _ungrouped(t.float(), E)


def fake_quant(x: torch.Tensor, codec) -> torch.Tensor:
    """dequantize(quantize(x)) — the value the receiver reconstructs."""
    c = get_codec(codec)
    if c is None:
        return x
    # the sign of a zero zero-point changes no dequantized value: skip
    # the pass over x that fixes it
    return dequantize_rows(*_quantize(x, c, zero_sign=False), c)


def ste(x: torch.Tensor, codec) -> torch.Tensor:
    """Straight-through estimator: the value ``x + (fake_quant(x) - x)``
    (the reference's, rounded as it rounds it), the gradient the
    identity."""
    c = get_codec(codec)
    if c is None:
        return x
    v = x.detach()
    return x + (fake_quant(v, c) - v)


def quantize_with_feedback(g: torch.Tensor, residual: torch.Tensor, codec):
    """Error-feedback gradient quantization (grads-up PS push).

    Returns ``(g_hat, new_residual)``: the pushed gradient is
    ``fake_quant(g + residual)`` and the quantization error carries to
    the next step.  The optimizer must see ``g_hat``.  codec=None is the
    exact identity (residual stays zero).
    """
    c = get_codec(codec)
    if c is None:
        return g, residual
    acc = g + residual
    g_hat = fake_quant(acc, c)
    return g_hat, acc - g_hat


# --------------------------------------------------------------------------
# int4 nibble packing (the byte-exact wire layout)
# --------------------------------------------------------------------------
def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(..., E) int codes in [0, 15] -> (..., ceil(E/2)) uint8.

    Even columns take the low nibble, odd the high; an odd tail packs a
    zero high nibble (exactly the :func:`wire_row_bytes` count).
    """
    E = codes.shape[-1]
    q = codes.clamp(0, 15).to(torch.uint8)
    if E % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    pairs = q.reshape(q.shape[:-1] + ((E + 1) // 2, 2))
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack_int4(packed: torch.Tensor, E: int) -> torch.Tensor:
    """Invert :func:`pack_int4` back to (..., E) uint8 codes."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (-1,))
    return out[..., :E]
