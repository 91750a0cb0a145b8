"""Embedding-row kernels: wrappers and plain versions.

* :func:`pooled_lookup` — ``out[b] = sum_f w[b, f] * table[ids[b, f]]``:
  the pooled bag, and on the training step Alg. 1 over a compact per-id
  cost table (:func:`repro_torch.kernels.ops.cost_matrix_sparse_kernel`).
  Replaces the Pallas TPU kernel ``repro/kernels/emb_lookup.py:
  pooled_lookup``.
* :func:`staged_gather` — ``out[s] = table[src[s]] if src[s] >= 0 else
  plane[s]``: the TTL refresh pull and merge into a cache plane.  Replaces
  the Pallas TPU kernel ``repro/kernels/emb_lookup.py:staged_gather``.
* :func:`pooled_lookup_staged` — the pooled history bag read from the
  plane where a live slot holds the id and from the table elsewhere, a
  warp per (bag, 128 columns) with its row loads in flight.  Replaces
  ``repro/kernels/emb_lookup.py:pooled_lookup_staged``.
* :func:`pooled_lookup_quant` — the pooled bag over a quantized table,
  ``out[b] = sum_f w[b, f] * (codes[id] * scale[id, g] + zp[id, g])``,
  the dequant fused into the accumulate, on :func:`pooled_lookup`'s warp
  per bag at E <= 32 and :func:`pooled_lookup_staged`'s warp per (bag,
  128 columns) above.  Replaces ``repro/kernels/emb_lookup.py:
  pooled_lookup_quant``.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/emb_lookup.cu``; that
file states what bounds each on the card and how its design answers it.
Each wrapper takes the reference's signature, checks device, dtype
(f32 rows, int32 indices), shape and contiguity, and raises on anything
the kernel does not take.  Given CUDA tensors it launches its kernel on
the current stream or raises; it runs the plain PyTorch version beside it
(``*_ref``) only because the tensors lie on the CPU.  ``LAUNCHES`` counts
kernel launches per kernel; nothing else adds to it.
"""
from __future__ import annotations

import torch

from ..quant.codecs import dequantize_rows, get_codec, group_size

__all__ = ["LAUNCHES", "pooled_lookup", "pooled_lookup_ref",
           "staged_gather", "staged_gather_ref",
           "pooled_lookup_staged", "pooled_lookup_staged_ref",
           "pooled_lookup_quant", "pooled_lookup_quant_ref"]

LAUNCHES = {"pooled_lookup": 0, "staged_gather": 0,
            "pooled_lookup_staged": 0, "pooled_lookup_quant": 0}

_MAX_F = 4096   # the longest bag pooled_lookup_staged takes


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape} (None = any)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(*ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1:
        raise ValueError("inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _vec4(E: int, *ts: torch.Tensor) -> int:
    return int(E % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


# --------------------------------------------------------------------------
# pooled_lookup
# --------------------------------------------------------------------------
def _pad_rule(ids: torch.Tensor, weights: torch.Tensor | None):
    """PAD ids (< 0) read row 0 with weight 0, as the reference's wrapper
    sets them up; ``None`` weights are all ones."""
    valid = ids >= 0
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=ids.device)
    ids_c = torch.where(valid, ids, torch.zeros_like(ids))
    w = torch.where(valid, weights, torch.zeros_like(weights))
    return ids_c, w


def pooled_lookup_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`pooled_lookup`: the sum over
    f = 0..F-1 in order, each product rounded before its add."""
    B, F = ids.shape
    V, E = table.shape
    ids_c, w = _pad_rule(ids, weights)
    ids_c = ids_c.long().clamp(max=V - 1)
    out = torch.zeros((B, E), dtype=torch.float32, device=table.device)
    for f in range(F):
        out = out + table[ids_c[:, f]] * w[:, f, None]
    return out


def pooled_lookup(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[b] = sum_f weights[b, f] * table[ids[b, f]].

    table: (V, E) f32; ids: (B, F) int32, PAD = -1 (row 0, weight 0; an
    id past the table clamps to its last row); weights: (B, F) f32 or
    None (all ones).  Returns (B, E) f32.
    """
    _check("table", table, torch.float32, (None, None))
    V, E = table.shape
    _check("ids", ids, torch.int32, (None, None))
    B, F = ids.shape
    if weights is not None:
        _check("weights", weights, torch.float32, (B, F))
    if not _on_cuda(table, ids, weights):
        return pooled_lookup_ref(table, ids, weights)
    if V == 0:
        raise ValueError("pooled_lookup needs a table with rows")
    from ._build import load_library

    lib = load_library("emb_lookup")
    out = torch.empty((B, E), dtype=torch.float32, device=table.device)
    # the kernel applies the PAD rule itself: one launch a call
    rc = lib.pooled_lookup_launch(
        table.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        B, F, E, V, torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, "pooled_lookup")
    LAUNCHES["pooled_lookup"] += 1
    return out


# --------------------------------------------------------------------------
# staged_gather
# --------------------------------------------------------------------------
def staged_gather_ref(plane_rows: torch.Tensor, table: torch.Tensor,
                      src_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`staged_gather`."""
    V = table.shape[0]
    take = src_rows >= 0
    pulled = table[src_rows.long().clamp(0, V - 1)]
    return torch.where(take[:, None], pulled, plane_rows)


def staged_gather(plane_rows: torch.Tensor, table: torch.Tensor,
                  src_rows: torch.Tensor) -> torch.Tensor:
    """out[s] = table[src_rows[s]] if src_rows[s] >= 0 else plane_rows[s].

    plane_rows: (C, E) f32; table: (V, E) f32; src_rows: (C,) int32
    (-1 = keep the slot's row; an index past the table clamps to its last
    row).  Returns a new (C, E) f32 plane.
    """
    _check("plane_rows", plane_rows, torch.float32, (None, None))
    C, E = plane_rows.shape
    _check("table", table, torch.float32, (None, E))
    _check("src_rows", src_rows, torch.int32, (C,))
    if not _on_cuda(plane_rows, table, src_rows):
        return staged_gather_ref(plane_rows, table, src_rows)
    from ._build import load_library

    lib = load_library("emb_lookup")
    out = torch.empty_like(plane_rows)
    rc = lib.staged_gather_launch(
        plane_rows.data_ptr(), table.data_ptr(), src_rows.data_ptr(),
        out.data_ptr(), C, E, table.shape[0],
        _vec4(E, plane_rows, table, out),
        torch.cuda.current_stream(plane_rows.device).cuda_stream)
    _raise_on(rc, "staged_gather")
    LAUNCHES["staged_gather"] += 1
    return out


# --------------------------------------------------------------------------
# pooled_lookup_staged
# --------------------------------------------------------------------------
def pooled_lookup_staged_ref(plane_rows: torch.Tensor, table: torch.Tensor,
                             slots: torch.Tensor, ids: torch.Tensor,
                             weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`pooled_lookup_staged`: the same
    per-bag sum over f = 0..F-1, in the same order."""
    B, F = ids.shape
    V, E = table.shape
    C = plane_rows.shape[0]
    valid = ids >= 0
    if weights is None:
        weights = torch.ones((B, F), dtype=torch.float32, device=ids.device)
    w = torch.where(valid, weights, torch.zeros_like(weights))
    ids_c = torch.where(valid, ids, torch.zeros_like(ids)).long()
    take = slots >= 0
    slot_c = slots.long().clamp(0, max(C - 1, 0))
    out = torch.zeros((B, E), dtype=torch.float32, device=table.device)
    for f in range(F):
        row = table[ids_c[:, f].clamp(max=V - 1)]
        if C:
            row = torch.where(take[:, f, None], plane_rows[slot_c[:, f]], row)
        out = out + row * w[:, f, None]
    return out


def pooled_lookup_staged(plane_rows: torch.Tensor, table: torch.Tensor,
                         slots: torch.Tensor, ids: torch.Tensor,
                         weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Pooled lookup that reads from the staging plane: per (bag, f),
    ``row = plane_rows[slots[b, f]]`` where a live slot holds the id
    (``slots >= 0``), else ``table[ids[b, f]]``; ``out[b] = sum_f
    weights[b, f] * row``.  PAD ids (< 0) contribute nothing.

    plane_rows: (C, E) f32; table: (V, E) f32; slots, ids: (B, F) int32;
    weights: (B, F) f32 or None (all ones).  Returns (B, E) f32.
    """
    _check("plane_rows", plane_rows, torch.float32, (None, None))
    C, E = plane_rows.shape
    _check("table", table, torch.float32, (None, E))
    _check("ids", ids, torch.int32, (None, None))
    B, F = ids.shape
    _check("slots", slots, torch.int32, (B, F))
    if weights is not None:
        _check("weights", weights, torch.float32, (B, F))
    if not _on_cuda(plane_rows, table, slots, ids, weights):
        return pooled_lookup_staged_ref(plane_rows, table, slots, ids,
                                        weights)
    if F > _MAX_F:
        raise ValueError(f"pooled_lookup_staged takes at most {_MAX_F} "
                         f"lookups per bag, got {F}")
    from ._build import load_library

    lib = load_library("emb_lookup")
    out = torch.empty((B, E), dtype=torch.float32, device=table.device)
    rc = lib.pooled_lookup_staged_launch(
        plane_rows.data_ptr(), table.data_ptr(), slots.data_ptr(),
        ids.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr(), B, F, E, C, table.shape[0],
        _vec4(E, plane_rows, table, out),
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, "pooled_lookup_staged")
    LAUNCHES["pooled_lookup_staged"] += 1
    return out


# --------------------------------------------------------------------------
# pooled_lookup_quant
# --------------------------------------------------------------------------
def pooled_lookup_quant_ref(codes: torch.Tensor, scale: torch.Tensor,
                            zp: torch.Tensor, ids: torch.Tensor,
                            weights: torch.Tensor | None = None, *,
                            codec) -> torch.Tensor:
    """Plain PyTorch version of :func:`pooled_lookup_quant`: each looked-up
    row dequantized (:func:`repro_torch.quant.codecs.dequantize_rows`, one
    rounding as a fused multiply-add), then the sum over f = 0..F-1 in
    order, each product rounded before its add."""
    c = get_codec(codec)
    if c.kind == "fp16":
        return pooled_lookup_ref(codes.float(), ids, weights)
    B, F = ids.shape
    V, E = codes.shape
    ids_c, w = _pad_rule(ids, weights)
    ids_c = ids_c.long().clamp(max=V - 1)
    out = torch.zeros((B, E), dtype=torch.float32, device=codes.device)
    for f in range(F):
        i = ids_c[:, f]
        row = dequantize_rows(codes[i], scale[i], zp[i], c)
        out = out + row * w[:, f, None]
    return out


def pooled_lookup_quant(codes: torch.Tensor, scale: torch.Tensor,
                        zp: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor | None = None, *,
                        codec) -> torch.Tensor:
    """Pooled lookup over a quantized table: ``out[b] = sum_f w[b, f] *
    (codes[ids[b, f]] * scale[ids[b, f], g] + zp[ids[b, f], g])`` with g
    the column's scale group, the f32 table never materialized.

    codes: (V, E) f32-valued integer codes (fp16 codec: the (V, E) f16
    cast, pooled by :func:`pooled_lookup` on ``codes.float()``, as the
    reference routes it); scale, zp: (V, G) f32; ids: (B, F) int32, PAD
    = -1 (row 0, weight 0; an id past the table clamps to its last
    row); weights: (B, F) f32 or None (all ones).  Returns (B, E) f32.
    """
    c = get_codec(codec)
    if c is None:
        raise ValueError("pooled_lookup_quant needs a codec")
    if c.kind == "fp16":
        _check("codes", codes, torch.float16, (None, None))
        return pooled_lookup(codes.float(), ids, weights)
    _check("codes", codes, torch.float32, (None, None))
    V, E = codes.shape
    Bg = group_size(E, c)
    G = -(-E // Bg)
    _check("scale", scale, torch.float32, (V, G))
    _check("zp", zp, torch.float32, (V, G))
    _check("ids", ids, torch.int32, (None, None))
    B, F = ids.shape
    if weights is not None:
        _check("weights", weights, torch.float32, (B, F))
    if not _on_cuda(codes, scale, zp, ids, weights):
        return pooled_lookup_quant_ref(codes, scale, zp, ids, weights,
                                       codec=c)
    if V == 0:
        raise ValueError("pooled_lookup_quant needs a table with rows")
    from ._build import load_library

    lib = load_library("emb_lookup")
    out = torch.empty((B, E), dtype=torch.float32, device=codes.device)
    # the kernel applies the PAD rule itself: one launch a call
    rc = lib.pooled_lookup_quant_launch(
        codes.data_ptr(), scale.data_ptr(), zp.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        B, F, E, V, Bg, G, _vec4(E, codes, out),
        torch.cuda.current_stream(codes.device).cuda_stream)
    _raise_on(rc, "pooled_lookup_quant")
    LAUNCHES["pooled_lookup_quant"] += 1
    return out
