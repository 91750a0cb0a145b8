"""The quantized wire's codecs, written from their description: a row is
cut into groups (the whole row, or ``block`` elements), each sent as
integer codes 0..levels over its [min, max] (int8: 255 levels, int4:
15) with an f32 scale (range / levels; 1 for a constant group) and an
f32 zero point (the minimum); fp16 is a cast.  The receiver's value is
codes * scale + zero point, taken in f64 and rounded once to f32."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["parse", "row_bytes", "fake_quant"]


def parse(spec):
    """``None`` | ``"int8"`` | ``"int4:32"`` | ``"fp16"`` -> (kind,
    block) or None."""
    if spec is None:
        return None
    kind, _, block = str(spec).partition(":")
    if kind not in ("fp16", "int8", "int4"):
        raise ValueError(f"unknown codec {spec!r}")
    return kind, int(block) if block else None


def row_bytes(elems: int, spec) -> int:
    """What a link carries for one row: codes plus an f32 scale and zero
    point a group."""
    c = parse(spec)
    if c is None:
        return 4 * elems
    kind, block = c
    if kind == "fp16":
        return 2 * elems
    groups = 1 if block is None else -(-elems // block)
    payload = elems if kind == "int8" else (elems + 1) // 2
    return payload + 8 * groups


def fake_quant(x: torch.Tensor, spec) -> torch.Tensor:
    """The value a row (..., E) f32 has after the wire."""
    c = parse(spec)
    if c is None:
        return x
    kind, block = c
    if kind == "fp16":
        return x.half().float()
    levels = 255 if kind == "int8" else 15
    E = x.shape[-1]
    B = E if block is None else min(block, E)
    pad = (-E) % B
    g = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1) if pad else x
    g = g.reshape(x.shape[:-1] + ((E + pad) // B, B))
    valid = (torch.arange(E + pad, device=x.device) < E).reshape(-1, B)
    lo = torch.where(valid, g, torch.inf).amin(-1, keepdim=True)
    hi = torch.where(valid, g, -torch.inf).amax(-1, keepdim=True)
    inv = float(np.float32(1.0) / np.float32(levels))
    scale = (hi - lo) * inv
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((g - lo) / scale), 0, levels)
    out = (q.double() * scale.double() + lo.double()).float()
    return out.reshape(x.shape[:-1] + (E + pad,))[..., :E]
