"""The ragged exchange's row packs: wrappers and plain versions.

* :func:`gather_rows` — ``out[s] = rows[slot_to_row[s]]`` where the
  index is >= 0, else a fill row — builds one worker's per-destination
  send blocks (:func:`repro_torch.exchange.ragged.pack_send`).  Replaces
  the Pallas TPU kernel ``repro/kernels/exchange_pack.py:
  gather_rows_pallas``.
* :func:`gather_rows_quant` — the same gather fused with the per-group
  affine quantize of :func:`repro_torch.quant.codecs.quantize_rows`: the
  quantized wire's pack (:func:`repro_torch.exchange.ragged.
  ragged_exchange_quant`).  Replaces ``repro/kernels/exchange_pack.py:
  gather_rows_quant_pallas``.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/exchange_pack.cu``,
which states what bounds them and how their design answers it.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take.  Given CUDA tensors it launches its
kernel on the current stream or raises; it runs the plain version
(``*_ref``) only because the tensors lie on the CPU.  ``LAUNCHES``
counts kernel launches; nothing else adds to it.
"""
from __future__ import annotations

import torch

from ..quant.codecs import get_codec, group_size, inv_levels, quantize_rows
from .emb_lookup import _check, _on_cuda, _raise_on

__all__ = ["LAUNCHES", "gather_rows", "gather_rows_ref", "gather_rows_quant",
           "gather_rows_quant_ref"]

LAUNCHES = {"gather_rows": 0, "gather_rows_quant": 0}

_DTYPES = (torch.int32, torch.float32)


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
    # the fill's 32-bit pattern in the rows' dtype: -1.0f for f32 rows
    word = int(torch.tensor([fill], dtype=rows.dtype).view(torch.int32)[0])
    out = torch.empty((S, F), dtype=rows.dtype, device=rows.device)
    rc = lib.gather_rows_launch(
        rows.data_ptr(), slot_to_row.data_ptr(), out.data_ptr(), S, F, m,
        word, torch.cuda.current_stream(rows.device).cuda_stream)
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
