"""The ragged exchange executor, over a worker dimension on one device.

The counterpart of the JAX package's ``exchange/ragged.py``.  Where the
reference runs inside ``shard_map`` with a ``lax.all_to_all``, the port
holds every worker's rows in one tensor with the worker as the leading
dimension, so the collective is a change of index into the stacked
``(n_src, n_dst, budget, ...)`` send blocks.  Three stages:

  pack          every worker's rows + assignment -> (n_src, n_dst,
                budget, ...) send blocks in stable source order, for
                every payload at once, + the (src, dst) count matrix +
                overflow: one launch of the pack kernel
                (:func:`repro_torch.kernels.exchange_pack.pack_send_all`);
  all_to_all    destination j's block i is source i's block j;
  compaction    each destination's valid prefixes, compacted to the
                front of its output: one gather over all destinations
                (:func:`_recv_index`, then :func:`_compact` a payload).

Wire order: a destination's batch is the concatenation over ascending
source of each source's rows in their original local order.  1-D rows
(labels) pack as (m, 1), where the reference scatters them.

:func:`ragged_exchange_many` moves several payloads over one assignment,
as the training step's advance moves ids, dense features and labels:
one pack launch for them all.  With a codec the float (n, m, E)
payloads take the quantized wire: the same pack launch quantizes their
send slots (codes, scales and zero-points) beside the exact payloads'
copies, and the receivers dequantize before they compact.
:func:`ragged_exchange` and :func:`ragged_exchange_quant` are its
one-payload forms, :func:`pack_send` and :func:`compact_recv` its stages
for one worker.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels.exchange_pack import pack_send_all
from ..quant.codecs import dequantize_rows, get_codec

__all__ = ["pack_send", "compact_recv", "ragged_exchange",
           "ragged_exchange_many", "ragged_exchange_quant"]


def pack_send(rows: torch.Tensor, assign: torch.Tensor, n: int, budget: int,
              fill: int = -1):
    """Pack one worker's rows into per-destination send blocks.

    rows: (m, ...) int32 or f32 payload; assign: (m,) destination in
    [0, n).  Returns (send (n, budget, ...), counts (n,) int32, overflow
    () int32).  Rows keep their order within each destination block;
    rows beyond ``budget`` for a destination are dropped from the wire
    and counted in ``overflow`` (the driver raises on it).
    """
    (send,), _, counts, overflow = pack_send_all(
        assign[None], [rows[None]], n, budget, fill)
    return send[0], counts[0], overflow


def _recv_index(counts: torch.Tensor, budget: int, out_rows: int):
    """Where each destination's output rows come from.

    counts: (n_src, n_dst) rows each source sent each destination.
    Returns (at (n_dst, out_rows) int64, the row of the flattened
    (n_src, n_dst, budget) send blocks that lands at each output row;
    ok (n_dst, out_rows), False past the destination's valid rows;
    total (n_dst,) int32 valid rows received; recv_counts (n_dst, n_src)
    int32, the counts clamped to the block an overflowing sender
    shipped).
    """
    n_src, n_dst = counts.shape
    dev = counts.device
    recv_counts = counts.T.clamp(max=budget).contiguous()
    ends = torch.cumsum(recv_counts, dim=1)
    o = torch.arange(out_rows, device=dev)
    # the source block holding output row o: the first whose end is past o
    src = torch.searchsorted(ends, o.expand(n_dst, out_rows).contiguous(),
                             right=True).clamp_(max=n_src - 1)
    row = o[None, :] - (ends - recv_counts).gather(1, src)
    ok = o[None, :] < ends[:, -1:]
    dst = torch.arange(n_dst, device=dev)[:, None]
    at = torch.where(ok, (src * n_dst + dst) * budget + row, 0)
    return at, ok, ends[:, -1].to(torch.int32), recv_counts


def _compact(blocks: torch.Tensor, at: torch.Tensor, ok: torch.Tensor,
             fill: int) -> torch.Tensor:
    """(n_src, n_dst, budget, ...) send blocks -> (n_dst, out_rows, ...)
    compacted outputs, ``fill`` past each destination's valid rows."""
    tail = blocks.shape[3:]
    if blocks.shape[2] == 0:            # no budget: nothing on the wire
        return torch.full(at.shape + tail, fill, dtype=blocks.dtype,
                          device=blocks.device)
    got = blocks.reshape((-1,) + tail)[at]
    return torch.where(ok.reshape(ok.shape + (1,) * len(tail)), got, fill)


def compact_recv(recv: torch.Tensor, recv_counts: torch.Tensor,
                 out_rows: int, fill: int = -1):
    """Compact the valid prefixes of one worker's received blocks.

    recv: (n, budget, ...) blocks (block i from source i); recv_counts:
    (n,) valid rows per block.  Returns (out (out_rows, ...) with the
    payload rows first and ``fill`` after, total () int32).
    """
    at, ok, total, _ = _recv_index(recv_counts[:, None], recv.shape[1],
                                   out_rows)
    return _compact(recv[:, None], at, ok, fill)[0], total[0]


def ragged_exchange_many(payloads: Sequence[torch.Tensor],
                         assign: torch.Tensor, budget: int,
                         out_rows: int | None = None, fill: int = -1,
                         codec=None):
    """One ragged all-to-all step for several payloads over one
    assignment.

    payloads: (n, m, ...) int32 or f32 tensors, every worker's local
    rows; assign: (n, m) destination workers.  ``budget`` is the static
    per-link block (>= the dispatch capacity); ``out_rows`` sizes each
    worker's compacted output (default n * budget).  ``codec`` sends the
    float (n, m, E) payloads over the quantized wire; the others travel
    exact.  Returns (outs, one (n, out_rows, ...) per payload; total (n,)
    valid rows per worker; recv_counts (n_dst, n_src) rows received per
    link; overflow () int32 rows the cluster could not fit on the wire).
    """
    n = assign.shape[0]
    c = get_codec(codec)
    quant = [c is not None and a.dim() == 3 and a.is_floating_point()
             for a in payloads]
    sends, _, counts, overflow = pack_send_all(assign, payloads, n, budget,
                                               fill, c, quant)
    if out_rows is None:
        out_rows = n * budget
    at, ok, total, recv_counts = _recv_index(counts, budget, out_rows)
    outs = [_compact(dequantize_rows(*send, c) if q else send, at, ok, fill)
            for send, q in zip(sends, quant)]
    return outs, total, recv_counts, overflow


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
    (out,), total, recv_counts, overflow = ragged_exchange_many(
        [rows], assign, budget, out_rows, fill)
    return out, total, recv_counts, overflow


def ragged_exchange_quant(rows: torch.Tensor, assign: torch.Tensor,
                          budget: int, codec, out_rows: int | None = None,
                          fill: int = -1):
    """Quantized variant of :func:`ragged_exchange` for (n, m, E) float
    rows.

    Every source's send slots are packed and quantized in one launch
    (:func:`repro_torch.kernels.exchange_pack.pack_send_all` with the
    payload marked), the codes and the per-group scale and zero-point
    cross as separate tensors (the values of the reference's
    concatenated block), and each destination dequantizes its blocks
    before compacting them.  PAD fill rows are constant and come back
    bitwise ``fill``.  ``codec=None`` is the exact fp32 path.  Returns
    (out, total, recv_counts, overflow) like :func:`ragged_exchange`.
    """
    if get_codec(codec) is not None and rows.dim() != 3:
        raise ValueError("ragged_exchange_quant packs (n, m, E) float rows")
    (out,), total, recv_counts, overflow = ragged_exchange_many(
        [rows], assign, budget, out_rows, fill, codec)
    return out, total, recv_counts, overflow
