"""The ragged exchange's row pack: wrapper and plain version.

:func:`gather_rows` — ``out[s] = rows[slot_to_row[s]]`` where the index
is >= 0, else a fill row — builds one worker's per-destination send
blocks (:func:`repro_torch.exchange.ragged.pack_send`).  Replaces the
Pallas TPU kernel ``repro/kernels/exchange_pack.py:gather_rows_pallas``.
The kernel is CUDA C++ for ``sm_90a`` in ``csrc/exchange_pack.cu``,
which states what bounds it and how its design answers it.

The wrapper checks device, dtype (int32 or f32 rows, int32 indices),
shape and contiguity and raises on anything the kernel does not take.
Given CUDA tensors it launches its kernel on the current stream or
raises; it runs :func:`gather_rows_ref` only because the tensors lie on
the CPU.  ``LAUNCHES`` counts kernel launches; nothing else adds to it.
"""
from __future__ import annotations

import torch

from .emb_lookup import _check, _on_cuda, _raise_on

__all__ = ["LAUNCHES", "gather_rows", "gather_rows_ref"]

LAUNCHES = {"gather_rows": 0}

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
