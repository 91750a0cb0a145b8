"""The ragged exchange executor, over a worker dimension on one device.

The counterpart of the JAX package's ``exchange/ragged.py``.  Where the
reference runs inside ``shard_map`` with a ``lax.all_to_all``, the port
holds every worker's rows in one tensor with the worker as the leading
dimension, so the collective is a transpose of the stacked
``(n_src, n_dst, budget, ...)`` send blocks.  Three stages:

  pack_send     one worker's rows + assignment -> (n, budget, ...) send
                blocks in stable source order, built by the row-pack
                kernel (:func:`repro_torch.kernels.exchange_pack.
                gather_rows`), + per-destination counts + overflow;
  all_to_all    ``send.transpose(0, 1)`` of the stacked blocks, and the
                (src, dst) count matrix;
  compact_recv  mask each (src -> me) block to its valid prefix and
                compact the payload rows to the front of the output.

Wire order: a destination's batch is the concatenation over ascending
source of each source's rows in their original local order.  Every pack
goes through the kernel: 1-D rows (labels) pack as (m, 1), where the
reference scatters them.

:func:`ragged_exchange_quant` is the quantized wire for float rows: the
pack quantizes each send slot's row (kernel :func:`repro_torch.kernels.
exchange_pack.gather_rows_quant`), codes, scales and zero-points cross
the transpose, and each receiver dequantizes before it compacts.
"""
from __future__ import annotations

import torch

from ..kernels.exchange_pack import gather_rows, gather_rows_quant
from ..quant.codecs import dequantize_rows, get_codec

__all__ = ["pack_send", "compact_recv", "ragged_exchange",
           "ragged_exchange_quant"]


def _slots(assign: torch.Tensor, n: int, budget: int):
    """One worker's wire layout: ``slot_to_row`` ((n * budget,) int32,
    -1 = PAD slot), counts (n,) int32 and overflow () int32."""
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
    # overflow rows route to a scratch slot past the buffer and drop
    slot = torch.where(pos < budget, a * budget + pos, n * budget)
    slot_to_row = torch.full((n * budget + 1,), -1, dtype=torch.int32,
                             device=dev)
    slot_to_row.scatter_(0, slot, torch.arange(m, dtype=torch.int32,
                                               device=dev))
    return slot_to_row[:n * budget], counts.to(torch.int32), overflow


def pack_send(rows: torch.Tensor, assign: torch.Tensor, n: int, budget: int,
              fill: int = -1):
    """Pack one worker's rows into per-destination send blocks.

    rows: (m, ...) int32 or f32 payload; assign: (m,) destination in
    [0, n).  Returns (send (n, budget, ...), counts (n,) int32, overflow
    () int32).  Rows keep their order within each destination block;
    rows beyond ``budget`` for a destination are dropped from the wire
    and counted in ``overflow`` (the driver raises on it).
    """
    slot_to_row, counts, overflow = _slots(assign, n, budget)
    send = gather_rows(rows.reshape(rows.shape[0], -1), slot_to_row, fill)
    return send.reshape((n, budget) + rows.shape[1:]), counts, overflow


def compact_recv(recv: torch.Tensor, recv_counts: torch.Tensor,
                 out_rows: int, fill: int = -1):
    """Compact the valid prefixes of one worker's received blocks.

    recv: (n, budget, ...) blocks (block i from source i); recv_counts:
    (n,) valid rows per block.  Returns (out (out_rows, ...) with the
    payload rows first and ``fill`` after, total () int32).
    """
    n, budget = recv.shape[:2]
    tail = recv.shape[2:]
    valid = (torch.arange(budget, device=recv.device)[None, :]
             < recv_counts[:, None])
    vflat = valid.reshape(-1)
    flat = recv.reshape((n * budget,) + tail)
    dest = torch.cumsum(vflat, 0) - 1
    idx = torch.where(vflat & (dest < out_rows), dest, out_rows)
    out = torch.full((out_rows + 1,) + tail, fill, dtype=recv.dtype,
                     device=recv.device)
    out.index_copy_(0, idx, flat)
    return out[:out_rows], vflat.sum().to(torch.int32)


def ragged_exchange(rows: torch.Tensor, assign: torch.Tensor, budget: int,
                    out_rows: int | None = None, fill: int = -1):
    """One ragged all-to-all step over the worker dimension.

    rows: (n, m, ...) every worker's local payload; assign: (n, m)
    destination workers.  ``budget`` is the static per-link block (>=
    the dispatch capacity); ``out_rows`` sizes each worker's compacted
    output (default n * budget).  Returns (out (n, out_rows, ...), total
    (n,) valid rows per worker, recv_counts (n_dst, n_src) rows received
    per link, overflow () int32 rows the cluster could not fit on the
    wire).
    """
    n = rows.shape[0]
    packed = [pack_send(rows[i], assign[i], n, budget, fill=fill)
              for i in range(n)]
    send = torch.stack([p[0] for p in packed])       # (src, dst, budget, ...)
    counts_mat = torch.stack([p[1] for p in packed])           # (src, dst)
    overflow = torch.stack([p[2] for p in packed]).sum().to(torch.int32)
    recv = send.transpose(0, 1)                      # (dst, src, budget, ...)
    # receivers must not read past the block an overflowing sender shipped
    recv_counts = counts_mat.T.clamp(max=budget)
    if out_rows is None:
        out_rows = n * budget
    outs = [compact_recv(recv[j], recv_counts[j], out_rows, fill=fill)
            for j in range(n)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), recv_counts, overflow)


def ragged_exchange_quant(rows: torch.Tensor, assign: torch.Tensor,
                          budget: int, codec, out_rows: int | None = None,
                          fill: int = -1):
    """Quantized variant of :func:`ragged_exchange` for (n, m, E) float
    rows.

    Each source packs and quantizes its send slots in one pass (kernel
    :func:`repro_torch.kernels.exchange_pack.gather_rows_quant`), the
    codes and the per-group scale and zero-point cross the transpose as
    separate tensors (the values of the reference's concatenated block),
    and each destination dequantizes its blocks before compacting them.
    PAD fill rows are constant and come back bitwise ``fill``.
    ``codec=None`` is the exact fp32 path.  Returns (out, total,
    recv_counts, overflow) like :func:`ragged_exchange`.
    """
    c = get_codec(codec)
    if c is None:
        return ragged_exchange(rows, assign, budget, out_rows=out_rows,
                               fill=fill)
    if rows.dim() != 3:
        raise ValueError("ragged_exchange_quant packs (n, m, E) float rows")
    n, _, E = rows.shape
    wire, counts, overflow = [], [], []
    for i in range(n):
        slot_to_row, cnt, ov = _slots(assign[i], n, budget)
        wire.append(gather_rows_quant(rows[i], slot_to_row, c, fill))
        counts.append(cnt)
        overflow.append(ov)
    # (src, dst * budget, ...) -> (dst, src, budget, ...)
    codes, scale, zp = (
        torch.stack(t).reshape((n, n, budget, -1)).transpose(0, 1)
        for t in zip(*wire))
    recv_counts = torch.stack(counts).T.clamp(max=budget)
    if out_rows is None:
        out_rows = n * budget
    outs = [compact_recv(dequantize_rows(codes[j], scale[j], zp[j], c),
                         recv_counts[j], out_rows, fill=fill)
            for j in range(n)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), recv_counts,
            torch.stack(overflow).sum().to(torch.int32))
