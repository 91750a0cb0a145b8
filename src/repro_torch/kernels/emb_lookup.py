"""Embedding-row kernels: wrappers and plain versions.

* :func:`pooled_lookup` — ``out[b] = sum_f w[b, f] * table[ids[b, f]]``:
  the pooled bag, and on the training step Alg. 1 over a compact per-id
  cost table (:func:`repro_torch.kernels.ops.cost_matrix_sparse_kernel`).
  Replaces the Pallas TPU kernel ``repro/kernels/emb_lookup.py:
  pooled_lookup``.
* :func:`staged_gather` — ``out[s] = table[src[s]] if src[s] >= 0 else
  plane[s]``, out of place, as the TPU function writes a new plane.
  Replaces the Pallas TPU kernel ``repro/kernels/emb_lookup.py:
  staged_gather``; no main path runs it.
* :func:`staged_pull` — ``rows[slot[r]] = table[src[r]]`` in place over a
  compacted list: the training prefetch pull and the codec refresh's
  write.  :func:`plane_refresh` — the serving plane's TTL refresh in
  place: the due slots, the budget's stalest by a stable (expiry, slot)
  select, their rows pulled and expiry stamped, the count on the
  device.  Both replace ``staged_gather`` on the port's paths and touch
  only the rows they pull.
* :func:`pooled_lookup_staged` — the pooled history bag read from the
  plane where a live slot holds the id and from the table elsewhere, a
  warp per (bag, 128 columns) with its row loads in flight.  Replaces
  ``repro/kernels/emb_lookup.py:pooled_lookup_staged``.
* :func:`alg1_cost` — Alg. 1 for all n workers in one launch: each
  (worker, sample) bag's kept ids priced straight from the (n, V) state
  planes and summed in f order, bit for bit the per-worker route of
  :func:`repro_torch.kernels.ops.cost_matrix_sparse_kernel` (a compact
  per-id table pooled on :func:`pooled_lookup`).  Replaces no TPU
  kernel: it fuses the reference's ``cost_matrix_pallas_sparse`` pricing
  into B1's pooling.
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
(``*_ref``) only because the tensors lie on the CPU (or on ``meta``,
whose tensors carry shapes and no values: the dry run's).  Any other
device raises.  ``LAUNCHES`` counts kernel launches per kernel; nothing
else adds to it.
"""
from __future__ import annotations

import torch

from ..quant.codecs import dequantize_rows, get_codec, group_size

__all__ = ["LAUNCHES", "pooled_lookup", "pooled_lookup_ref",
           "staged_gather", "staged_gather_ref",
           "staged_pull", "staged_pull_ref",
           "plane_refresh", "plane_refresh_ref",
           "pooled_lookup_staged", "pooled_lookup_staged_ref",
           "pooled_lookup_quant", "pooled_lookup_quant_ref",
           "ALG1_MAX_WORKERS", "alg1_cost", "alg1_cost_ref"]

LAUNCHES = {"pooled_lookup": 0, "staged_gather": 0, "staged_pull": 0,
            "plane_refresh": 0,
            "pooled_lookup_staged": 0, "pooled_lookup_quant": 0,
            "alg1_cost": 0}

_MAX_F = 4096   # the longest bag pooled_lookup_staged takes
ALG1_MAX_WORKERS = 32   # alg1_cost: a warp's lanes, a cost column each


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
    # meta tensors (the dry run's shapes) take the plain version too:
    # they carry no values, so nothing is hidden
    if dev.type in ("cpu", "meta"):
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
# staged_pull
# --------------------------------------------------------------------------
def staged_pull_ref(rows: torch.Tensor, table: torch.Tensor,
                    slot: torch.Tensor,
                    src: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`staged_pull`."""
    C, V = rows.shape[0], table.shape[0]
    if src is None:
        src = torch.arange(slot.shape[0], dtype=torch.int32,
                           device=slot.device)
    keep = (slot >= 0) & (slot < C)
    rows[slot[keep].long()] = table[src[keep].long().clamp(0, V - 1)]
    return rows


def staged_pull(rows: torch.Tensor, table: torch.Tensor, slot: torch.Tensor,
                src: torch.Tensor | None = None) -> torch.Tensor:
    """In place: ``rows[slot[r]] = table[src[r]]`` for every r, and
    returns ``rows``.

    rows: (C, E) f32; table: (V, E) f32; slot: (n,) int32, distinct, a
    slot outside [0, C) skipped (C marks none); src: (n,) int32, an index
    outside the table clamped into it, or None for ``src[r] = r``.  Only
    the pulled rows are read and written.
    """
    _check("rows", rows, torch.float32, (None, None))
    C, E = rows.shape
    _check("table", table, torch.float32, (None, E))
    _check("slot", slot, torch.int32, (None,))
    n = slot.shape[0]
    if src is not None:
        _check("src", src, torch.int32, (n,))
    if not _on_cuda(rows, table, slot, src):
        return staged_pull_ref(rows, table, slot, src)
    if table.shape[0] == 0 and n and C:
        raise ValueError("staged_pull needs a table with rows")
    from ._build import load_library

    lib = load_library("emb_lookup")
    rc = lib.staged_pull_launch(
        rows.data_ptr(), table.data_ptr(), slot.data_ptr(),
        None if src is None else src.data_ptr(), n, C, E, table.shape[0],
        _vec4(E, rows, table),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(rc, "staged_pull")
    LAUNCHES["staged_pull"] += 1
    return rows


# --------------------------------------------------------------------------
# plane_refresh
# --------------------------------------------------------------------------
_INT32_MAX = torch.iinfo(torch.int32).max
_BLOCK_PULL = 256   # the longest list plane_refresh's block pulls itself


def _int32(name: str, v: int) -> int:
    v = int(v)
    if not -2 ** 31 <= v < 2 ** 31:
        raise ValueError(f"{name} = {v} does not fit int32")
    return v


def plane_refresh_ref(plane, table: torch.Tensor, step: int, ttl: int,
                      budget: int | None = None, *, pull: bool = True):
    """Plain PyTorch version of :func:`plane_refresh`: the reference's
    stable argsort of the keys and its rank scatter."""
    ids, rows, expiry = plane.ids, plane.rows, plane.expiry
    C, V = ids.shape[0], table.shape[0]
    due = (ids >= 0) & (expiry <= step)
    if budget is not None and budget < C:
        order = torch.argsort(torch.where(due, expiry, _INT32_MAX),
                              stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(C, device=order.device)
        due = due & (rank < budget)
    cap = C if budget is None else max(0, min(int(budget), C))
    sel = torch.nonzero(due).flatten()
    n = sel.shape[0]
    expiry[sel] = int(step) + int(ttl)
    n_refreshed = torch.tensor(n, dtype=torch.int32, device=ids.device)
    if pull:
        rows[sel] = table[ids[sel].long().clamp(0, V - 1)]
        return n_refreshed, None, None
    sel_slot = torch.full((cap,), C, dtype=torch.int32, device=ids.device)
    sel_ids = torch.full((cap,), -1, dtype=torch.int32, device=ids.device)
    sel_slot[:n] = sel.to(torch.int32)
    sel_ids[:n] = ids[sel]
    return n_refreshed, sel_slot, sel_ids


def plane_refresh(plane, table: torch.Tensor, step: int, ttl: int,
                  budget: int | None = None, *, pull: bool = True):
    """One TTL round over a cache plane, in place.

    A slot is due when ``ids >= 0`` and ``expiry <= step``.  With a
    ``budget`` only the due slots ranked below it by ``(expiry, slot)``
    are kept (the stalest first, ties by slot); without one every due
    slot.  The kept slots get ``expiry = step + ttl`` and, with ``pull``,
    their rows ``table[ids]`` (clamped into the table).  ``plane`` has
    ``ids`` (C,) int32, ``rows`` (C, E) f32 and ``expiry`` (C,) int32,
    updated in place; no row that is not kept is read or written.

    Returns ``(n_refreshed, sel_slot, sel_ids)``: the count, a 0-dim
    int32 on the plane's device; with ``pull=False`` the kept slots in
    slot order and their ids, (cap,) int32 padded with ``(C, -1)``, cap
    ``min(budget, C)`` (C without a budget), and the rows left as they
    were; with ``pull`` None and None.  One launch with a list of at most
    256 rows, else a second, :func:`staged_pull`; no host sync.
    """
    ids, rows, expiry = plane.ids, plane.rows, plane.expiry
    _check("ids", ids, torch.int32, (None,))
    C = ids.shape[0]
    _check("expiry", expiry, torch.int32, (C,))
    _check("rows", rows, torch.float32, (C, None))
    E = rows.shape[1]
    _check("table", table, torch.float32, (None, E))
    step, ttl = _int32("step", step), _int32("ttl", ttl)
    if budget is not None:
        budget = _int32("budget", budget)
    if not _on_cuda(ids, rows, expiry, table):
        return plane_refresh_ref(plane, table, step, ttl, budget, pull=pull)
    if pull and table.shape[0] == 0 and C:
        raise ValueError("plane_refresh needs a table with rows")
    from ._build import load_library

    lib = load_library("emb_lookup")
    K = C if budget is None else max(0, min(budget, C))
    block_pull = pull and K <= _BLOCK_PULL
    count = torch.empty((), dtype=torch.int32, device=ids.device)
    sel_slot = sel_ids = None
    if not block_pull:
        sel_slot = torch.empty((K,), dtype=torch.int32, device=ids.device)
        sel_ids = torch.empty((K,), dtype=torch.int32, device=ids.device)
    rc = lib.plane_refresh_launch(
        ids.data_ptr(), expiry.data_ptr(), rows.data_ptr(),
        table.data_ptr(), None if sel_slot is None else sel_slot.data_ptr(),
        None if sel_ids is None else sel_ids.data_ptr(), count.data_ptr(),
        C, E, table.shape[0], step, ttl, K, K, int(block_pull),
        _vec4(E, rows, table),
        torch.cuda.current_stream(ids.device).cuda_stream)
    _raise_on(rc, "plane_refresh")
    LAUNCHES["plane_refresh"] += 1
    if pull and not block_pull:
        staged_pull(rows, table, sel_slot, sel_ids)
        sel_slot = sel_ids = None
    return count, sel_slot, sel_ids


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


# --------------------------------------------------------------------------
# alg1_cost
# --------------------------------------------------------------------------
def alg1_cost_ref(samples: torch.Tensor, latest: torch.Tensor,
                  dirty: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`alg1_cost`: every slot priced by
    the per-id formula in its float ops and order, weighted 1 where kept
    and 0 elsewhere, and summed over f = 0..F-1 in order, each product
    rounded before its add."""
    n, m, F = samples.shape
    V = latest.shape[1]
    s = samples.reshape(n * m, F)
    earlier = torch.ones((F, F), dtype=torch.bool,
                         device=s.device).tril(-1)          # [f, j]: j < f
    repeat = ((s[:, :, None] == s[:, None, :]) & earlier).any(-1)
    w = ((s != -1) & ~repeat).to(torch.float32)             # (B, F)
    held = (s >= 0) & (s < V)
    col = torch.where(held, s, torch.zeros_like(s)).long()
    lat = (latest[:, col] & held).to(torch.float32)         # (n, B, F)
    d = (dirty[:, col] & held).to(torch.float32)
    t = t.to(torch.float32)
    te = t[:, None, None]
    p = d[0] * t[0]
    for j in range(1, n):
        p = p + d[j] * t[j]
    v = (1.0 - lat) * te + (p - d * te)
    acc = torch.zeros((n, n * m), dtype=torch.float32, device=s.device)
    for f in range(F):
        acc = acc + v[:, :, f] * w[:, f]
    return acc.T.reshape(n, m, n).contiguous()


def _check_plane(name: str, x: torch.Tensor, n: int):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != torch.bool:
        raise TypeError(f"{name} must be torch.bool, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"({n}, V)")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} must have unit column stride")


def alg1_cost(samples: torch.Tensor, latest: torch.Tensor,
              dirty: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Alg. 1 for every worker: ``out[i, s, e]`` is the cost of worker e
    training worker i's sample s,

        sum over the kept slots f of samples[i, s], in f order, of
        (1 - latest[e, id]) * t[e] + (sum_j dirty[j, id] * t[j]
                                      - dirty[e, id] * t[e])

    with the sum over j a left fold.  A slot is kept when its id is not
    PAD (-1) and no earlier slot of the sample holds it; an id outside
    [0, V) that is not PAD is priced as one no worker holds.

    samples: (n, m, F) int32; latest, dirty: (n, V) bool, unit column
    stride (any row stride); t: (n,) f32; n <= ``ALG1_MAX_WORKERS``.
    Returns (n, m, n) f32: one launch, no host sync.
    """
    _check("samples", samples, torch.int32, (None, None, None))
    n, m, F = samples.shape
    _check_plane("latest", latest, n)
    _check_plane("dirty", dirty, n)
    V = latest.shape[1]
    if dirty.shape[1] != V:
        raise ValueError(f"dirty has {dirty.shape[1]} columns, latest {V}")
    _check("t", t, torch.float32, (n,))
    if n > ALG1_MAX_WORKERS:
        raise ValueError(f"alg1_cost takes at most {ALG1_MAX_WORKERS} "
                         f"workers, got {n}")
    if not _on_cuda(samples, latest, dirty, t):
        return alg1_cost_ref(samples, latest, dirty, t)
    from ._build import load_library

    lib = load_library("emb_lookup")
    out = torch.empty((n, m, n), dtype=torch.float32, device=samples.device)
    rc = lib.alg1_cost_launch(
        samples.data_ptr(), latest.data_ptr(), dirty.data_ptr(),
        t.data_ptr(), out.data_ptr(), n * m, F, n, V, latest.stride(0),
        dirty.stride(0), torch.cuda.current_stream(samples.device).cuda_stream)
    _raise_on(rc, "alg1_cost")
    LAUNCHES["alg1_cost"] += 1
    return out
