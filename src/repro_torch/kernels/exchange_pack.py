"""The ragged exchange's row packs: wrappers and plain versions.

* :func:`pack_send_all` — the exchange's whole pack in one launch: every
  source worker's slot map (each row's destination block and stable rank
  in it; rows past the budget off the wire) and its send blocks for
  every payload (ids, dense features, labels), with the count matrix
  and the overflow (:mod:`repro_torch.exchange.ragged`).  A payload
  marked as quantized leaves as codes, scale and zero-point, quantized
  in the same launch (the quantized wire).  Replaces the Pallas TPU
  kernels ``repro/kernels/exchange_pack.py:gather_rows_pallas`` and
  ``gather_rows_quant_pallas`` and the slot-map code around them in
  ``repro/exchange/ragged.py:pack_send``.
* :func:`gather_rows` — ``out[s] = rows[slot_to_row[s]]`` where the
  index is >= 0, else a fill row: the row pack alone, given a slot map.
  Replaces ``repro/kernels/exchange_pack.py:gather_rows_pallas``.
* :func:`gather_rows_quant` — the same gather fused with the per-group
  affine quantize of :func:`repro_torch.quant.codecs.quantize_rows`,
  given a slot map.  Replaces ``repro/kernels/exchange_pack.py:
  gather_rows_quant_pallas``.

On the training step only :func:`pack_send_all` runs; the two packs
alone are held against their plain versions on the card.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/exchange_pack.cu``,
which states what bounds them and how their design answers it.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take.  Given CUDA tensors it launches its
kernel on the current stream or raises; it runs the plain version
(``*_ref``) only because the tensors lie on the CPU.  ``LAUNCHES``
counts kernel launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..quant.codecs import get_codec, group_size, inv_levels, quantize_rows
from .emb_lookup import _check, _on_cuda, _raise_on

__all__ = ["LAUNCHES", "slot_map_ref", "pack_send_all",
           "pack_send_all_ref", "gather_rows", "gather_rows_ref",
           "gather_rows_quant", "gather_rows_quant_ref"]

# pack_send_all counts its two kernels apart: all payloads exact, or some
# quantized ("pack_send_all_quant")
LAUNCHES = {"pack_send_all": 0, "pack_send_all_quant": 0, "gather_rows": 0,
            "gather_rows_quant": 0}

_DTYPES = (torch.int32, torch.float32)
# pack_send_all's limits (csrc/exchange_pack.cu): workers on either side,
# rows a source, payloads a launch
MAX_WORKERS, MAX_ROWS, MAX_PAYLOADS = 32, 65536, 4


def _fill_word(fill: int, dtype: torch.dtype) -> int:
    """The fill's 32-bit pattern in ``dtype``: -1.0f for f32 rows."""
    return int(torch.tensor([fill], dtype=dtype).view(torch.int32)[0])


# --------------------------------------------------------------------------
# pack_send_all
# --------------------------------------------------------------------------
def slot_map_ref(assign: torch.Tensor, n: int, budget: int):
    """One source worker's wire layout: ``slot_to_row`` ((n * budget,)
    int32, -1 = PAD slot), counts (n,) int32 and overflow () int32.  Rows
    keep their order within each destination block; rows past ``budget``
    route to a scratch slot past the buffer and drop."""
    m = assign.shape[0]
    dev = assign.device
    a = assign.long()
    counts = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts.scatter_add_(0, a, torch.ones_like(a))
    starts = torch.cumsum(counts, 0) - counts
    # stable rank of each row within its destination group
    order = torch.argsort(a, stable=True)
    rank = torch.empty_like(a).scatter_(
        0, order, torch.arange(m, device=dev))
    pos = rank - starts[a]
    overflow = (pos >= budget).sum().to(torch.int32)
    slot = torch.where(pos < budget, a * budget + pos, n * budget)
    slot_to_row = torch.full((n * budget + 1,), -1, dtype=torch.int32,
                             device=dev)
    slot_to_row.scatter_(0, slot, torch.arange(m, dtype=torch.int32,
                                               device=dev))
    return slot_to_row[:n * budget], counts.to(torch.int32), overflow


def _marks(payloads, codec, quantized) -> tuple:
    """Which payloads take the quantized wire; raises on a mark the pack
    cannot honour."""
    marks = tuple(bool(x) for x in quantized) or (False,) * len(payloads)
    if len(marks) != len(payloads):
        raise ValueError(f"quantized has {len(marks)} marks for "
                         f"{len(payloads)} payloads")
    for q, (rows, mark) in enumerate(zip(payloads, marks)):
        if mark and (get_codec(codec) is None or rows.dtype != torch.float32
                     or rows.dim() != 3):
            raise ValueError(f"payload {q} is marked as quantized: it needs "
                             f"a codec and (n_src, m, F) float32 rows")
    return marks


def pack_send_all_ref(assign: torch.Tensor, payloads: Sequence[torch.Tensor],
                      n: int, budget: int, fill: int = -1, codec=None,
                      quantized: Sequence[bool] = ()):
    """Plain PyTorch version of :func:`pack_send_all`: each source's
    :func:`slot_map_ref`, then a :func:`gather_rows_ref` (or, for a
    quantized payload, a :func:`gather_rows_quant_ref`) per payload."""
    n_src, m = assign.shape
    marks = _marks(payloads, codec, quantized)
    maps, counts, overflow = [], [], []
    for i in range(n_src):
        stm, cnt, ov = slot_map_ref(assign[i], n, budget)
        maps.append(stm)
        counts.append(cnt)
        overflow.append(ov)
    sends = []
    for rows, mark in zip(payloads, marks):
        flat = [rows[i].reshape(m, math.prod(rows.shape[2:]))
                for i in range(n_src)]
        if mark:
            wire = [gather_rows_quant_ref(r, stm, codec, fill)
                    for r, stm in zip(flat, maps)]
            sends.append(tuple(
                torch.stack(t).reshape((n_src, n, budget, t[0].shape[-1]))
                for t in zip(*wire)))
        else:
            sends.append(torch.stack([gather_rows_ref(r, stm, fill)
                                      for r, stm in zip(flat, maps)])
                         .reshape((n_src, n, budget) + rows.shape[2:]))
    return (sends, torch.stack(maps), torch.stack(counts),
            torch.stack(overflow).sum().to(torch.int32))


def pack_send_all(assign: torch.Tensor, payloads: Sequence[torch.Tensor],
                  n: int, budget: int, fill: int = -1, codec=None,
                  quantized: Sequence[bool] = ()):
    """Pack every source worker's rows into per-destination send blocks,
    for several payloads over one assignment, in one launch.

    assign: (n_src, m) int32, each row's destination in [0, n);
    payloads: up to 4 (n_src, m, ...) int32 or f32 tensors (labels as
    (n_src, m)).  ``quantized`` marks, one bool a payload (empty: none),
    the (n_src, m, F) f32 payloads that leave quantized by ``codec``.
    Returns (sends, one (n_src, n, budget, ...) per payload with PAD
    slots ``fill`` in the payload's dtype, or for a quantized payload
    ``(codes (n_src, n, budget, F), scale (..., G), zp (..., G))`` as
    :func:`gather_rows_quant` gives them; slot_to_row (n_src, n * budget)
    int32, -1 = PAD; counts (n_src, n) int32; overflow () int32, the rows
    past a destination's budget, left off the wire).  Rows keep their
    local order within each destination block.  With no payloads it
    builds the slot maps alone.
    """
    _check("assign", assign, torch.int32, (None, None))
    n_src, m = assign.shape
    for q, rows in enumerate(payloads):
        if not isinstance(rows, torch.Tensor) or rows.dtype not in _DTYPES:
            raise TypeError(f"payload {q} must be an int32 or float32 "
                            f"tensor")
        if rows.dim() < 2 or tuple(rows.shape[:2]) != (n_src, m):
            raise ValueError(f"payload {q} has shape {tuple(rows.shape)}, "
                             f"expected ({n_src}, {m}, ...)")
        if not rows.is_contiguous():
            raise ValueError(f"payload {q} must be contiguous")
    marks = _marks(payloads, codec, quantized)
    if n < 1 or budget < 0:
        raise ValueError(f"pack_send_all needs n >= 1 and budget >= 0, got "
                         f"n={n}, budget={budget}")
    if not _on_cuda(assign, *payloads):
        return pack_send_all_ref(assign, payloads, n, budget, fill, codec,
                                 marks)
    if (n_src > MAX_WORKERS or n > MAX_WORKERS or m > MAX_ROWS
            or len(payloads) > MAX_PAYLOADS):
        raise ValueError(
            f"pack_send_all takes at most {MAX_WORKERS} workers on either "
            f"side, {MAX_ROWS} rows a source and {MAX_PAYLOADS} payloads, "
            f"got {n_src} -> {n}, m={m}, {len(payloads)} payloads")
    from ._build import load_library

    lib = load_library("exchange_pack")
    dev = assign.device
    c = get_codec(codec)
    sends, outs, scales, zps, groups, n_groups = [], [], [], [], [], []
    for rows, mark in zip(payloads, marks):
        F = math.prod(rows.shape[2:])
        B = G = 1
        if mark and c.kind != "fp16":
            B = group_size(F, c)
            G = -(-F // B)
        code_dtype = (torch.float16 if mark and c.kind == "fp16"
                      else rows.dtype)
        out = torch.empty((n_src, n, budget) + rows.shape[2:],
                          dtype=code_dtype, device=dev)
        outs.append(out.data_ptr())
        if mark:
            sc, zp = (torch.empty((n_src, n, budget, G), dtype=torch.float32,
                                  device=dev) for _ in range(2))
            sends.append((out, sc, zp))
            scales.append(sc.data_ptr())
            zps.append(zp.data_ptr())
        else:
            sends.append(out)
            scales.append(None)
            zps.append(None)
        groups.append(B)
        n_groups.append(G)
    slot_to_row = torch.empty((n_src, n * budget), dtype=torch.int32,
                              device=dev)
    counts = torch.empty((n_src, n), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    # the launcher reads the payloads' pointers, widths and fill words
    # (and the quantized payloads' side outputs) from host arrays, held
    # here until it returns
    ptrs, ints = ctypes.c_void_p * MAX_PAYLOADS, ctypes.c_int * MAX_PAYLOADS
    arrays = [ptrs(*[r.data_ptr() for r in payloads]), ptrs(*outs),
              ints(*[math.prod(r.shape[2:]) for r in payloads]),
              ints(*[_fill_word(fill, r.dtype) for r in payloads]),
              ptrs(*scales), ptrs(*zps), ints(*groups), ints(*n_groups)]
    at = [ctypes.addressof(a) for a in arrays]
    head = (assign.data_ptr(), *at[:4], len(payloads))
    tail = (slot_to_row.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            n_src, n, m, budget, torch.cuda.current_stream(dev).cuda_stream)
    if any(marks):
        rc = lib.pack_send_all_quant_launch(
            *head, *at[4:], float(c.levels),
            inv_levels(c) if c.kind != "fp16" else 0.0,
            int(c.kind == "fp16"), *tail)
        kernel = "pack_send_all_quant"
    else:
        rc = lib.pack_send_all_launch(*head, *tail)
        kernel = "pack_send_all"
    _raise_on(rc, kernel)
    LAUNCHES[kernel] += 1
    return sends, slot_to_row, counts, overflow


def gather_rows_ref(rows: torch.Tensor, slot_to_row: torch.Tensor,
                    fill: int = -1) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows`."""
    m, F = rows.shape
    take = slot_to_row >= 0
    if m == 0:
        return torch.full((slot_to_row.shape[0], F), fill, dtype=rows.dtype,
                          device=rows.device)
    got = rows[slot_to_row.long().clamp(0, m - 1)]
    return torch.where(take[:, None], got, torch.full_like(got, fill))


def gather_rows(rows: torch.Tensor, slot_to_row: torch.Tensor,
                fill: int = -1) -> torch.Tensor:
    """out[s] = rows[slot_to_row[s]] where slot_to_row[s] >= 0, else a
    row of ``fill`` in the rows' own dtype.

    rows: (m, F) int32 or f32; slot_to_row: (S,) int32 (an index past
    the rows clamps to the last row).  Returns (S, F) in rows.dtype.
    """
    if not isinstance(rows, torch.Tensor) or rows.dtype not in _DTYPES:
        raise TypeError("rows must be an int32 or float32 tensor")
    _check("rows", rows, rows.dtype, (None, None))
    m, F = rows.shape
    _check("slot_to_row", slot_to_row, torch.int32, (None,))
    if not _on_cuda(rows, slot_to_row):
        return gather_rows_ref(rows, slot_to_row, fill)
    from ._build import load_library

    lib = load_library("exchange_pack")
    S = slot_to_row.shape[0]
    out = torch.empty((S, F), dtype=rows.dtype, device=rows.device)
    rc = lib.gather_rows_launch(
        rows.data_ptr(), slot_to_row.data_ptr(), out.data_ptr(), S, F, m,
        _fill_word(fill, rows.dtype),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


# --------------------------------------------------------------------------
# gather_rows_quant
# --------------------------------------------------------------------------
def gather_rows_quant_ref(rows: torch.Tensor, slot_to_row: torch.Tensor,
                          codec, fill: int = -1):
    """Plain PyTorch version of :func:`gather_rows_quant`: the gather,
    then :func:`repro_torch.quant.codecs.quantize_rows` on the block."""
    return quantize_rows(gather_rows_ref(rows, slot_to_row, fill), codec)


def gather_rows_quant(rows: torch.Tensor, slot_to_row: torch.Tensor, codec,
                      fill: int = -1):
    """Fused pack + quantize: each send slot's row ``rows[slot_to_row[s]]``
    (a constant ``fill`` row for a PAD slot, index -1) and its per-group
    affine codes, scale and zero-point.

    rows: (m, F) f32; slot_to_row: (S,) int32 (an index past the rows
    clamps to the last row).  Returns ``(codes (S, F), scale (S, G), zp
    (S, G))`` as :func:`repro_torch.quant.codecs.quantize_rows` returns
    them: f32-valued integer codes for the int codecs; a PAD slot gets
    scale 1, zp ``fill`` and codes 0, so it dequantizes exactly to
    ``fill``.  fp16 is the row pack (:func:`gather_rows`) and a cast.
    No driver calls it: the exchange quantizes in :func:`pack_send_all`.
    """
    c = get_codec(codec)
    if c is None:
        raise ValueError("gather_rows_quant needs a codec")
    _check("rows", rows, torch.float32, (None, None))
    m, F = rows.shape
    _check("slot_to_row", slot_to_row, torch.int32, (None,))
    if c.kind == "fp16":
        out = gather_rows(rows, slot_to_row, fill)
        one = torch.ones((out.shape[0], 1), dtype=torch.float32,
                         device=out.device)
        return out.half(), one, torch.zeros_like(one)
    if not _on_cuda(rows, slot_to_row):
        return gather_rows_quant_ref(rows, slot_to_row, c, fill)
    from ._build import load_library

    lib = load_library("exchange_pack")
    S = slot_to_row.shape[0]
    B = group_size(F, c)
    G = -(-F // B)
    codes = torch.empty((S, F), dtype=torch.float32, device=rows.device)
    scale = torch.empty((S, G), dtype=torch.float32, device=rows.device)
    zp = torch.empty((S, G), dtype=torch.float32, device=rows.device)
    rc = lib.gather_rows_quant_launch(
        rows.data_ptr(), slot_to_row.data_ptr(), codes.data_ptr(),
        scale.data_ptr(), zp.data_ptr(), S, F, m, B, G, float(c.levels),
        inv_levels(c), float(fill),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(rc, "gather_rows_quant")
    LAUNCHES["gather_rows_quant"] += 1
    return codes, scale, zp
