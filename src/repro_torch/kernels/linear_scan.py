"""The linear recurrence of the SSM and hybrid LMs: wrappers, plain
versions, and the autograd Function the models train through.

:func:`linear_scan` — for f32 ``a``, ``b`` (B, S, C) and ``h0`` (B, C),
``h[:, t] = a[:, t] * h[:, t - 1] + b[:, t]`` from ``h[:, -1] = h0``;
returns ``(h (B, S, C), h_last (B, C))``.  The contract of the JAX
package's ``models/ssm.py::chunked_linear_scan`` (jnp, no Pallas kernel)
with its trailing axes flattened into C.  On the card it is
``csrc/linear_scan.cu``'s forward kernel: a block of 32 channels walks
the sequence in tiles, each thread's steps summed in order and the
tile's pieces joined through their composite maps (the source says what
bounds it and how the design answers it); on the CPU its plain version
:func:`linear_scan_ref`, the reference's chunked doubling scan.

:func:`linear_scan_backward` — the gradients ``(da, db, dh0)`` for ``g =
dL/dh`` and ``g_last = dL/dh_last``: ``dh[t] = g[t] + a[t + 1] dh[t +
1]``, ``da[t] = dh[t] h[t - 1]`` (``h[-1] = h0``), ``db = dh``, ``dh0 =
a[0] dh[0]``.  On the card the backward kernel of the same source; on
the CPU :func:`linear_scan_bwd_ref`, the plain scan run over the
reversed sequence.

Given CUDA tensors the wrappers launch their kernel on the current
stream or raise; they run the plain versions only because the tensors
lie on the CPU (or on ``meta``: shapes, no values).  ``LAUNCHES`` counts
the kernel launches.
:func:`scan` is the differentiable form (forward and backward one
launch each).  The kernel sums each thread's steps in order and XLA's
associative scan does not, so the two agree to f32 rounding: with every
``a`` in (0, 1) an error made at a step decays along the sequence
instead of growing, and the difference stays within a few ulps of
``max |h|``.
"""
from __future__ import annotations

import torch

from .emb_lookup import _on_cuda, _raise_on

__all__ = ["LAUNCHES", "SCAN_CHUNK", "linear_scan", "linear_scan_ref",
           "linear_scan_backward", "linear_scan_bwd_ref", "scan",
           "block_warps"]

LAUNCHES = {"linear_scan": 0, "linear_scan_bwd": 0}
SCAN_CHUNK = 256      # the reference's chunk, for the plain version
_LANES, _MANY_WARPS, _FEW_WARPS = 32, 32, 8


def _check(what: str, **ts):
    shape = None
    for name, t in ts.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be an f32 tensor, got "
                            f"{getattr(t, 'dtype', type(t).__name__)}")
        if name in ("h0", "g_last"):
            continue
        if t.dim() != 3:
            raise ValueError(f"{what}: {name} must be (B, S, C), got shape "
                             f"{tuple(t.shape)}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} differs from "
                             f"{tuple(shape)}")
        shape = t.shape
    B, S, C = shape
    for name in ("h0", "g_last"):
        t = ts.get(name)
        if t is not None and t.shape != (B, C):
            raise ValueError(f"{what}: {name} must be ({B}, {C}), got "
                             f"{tuple(t.shape)}")
    return B, S, C


def _contiguous(what: str, **ts):
    for name, t in ts.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} reads {name} {tuple(t.shape)} as a "
                             f"contiguous tensor; pass one")


def block_warps(n_blocks: int, n_sms: int) -> int:
    """Warps a block of the kernels: 8 when the grid's ``n_blocks`` (32
    channels each) fill every SM four times over, else 32, so that a
    narrow recurrence (RG-LRU's 80 blocks at B 1) has long tiles and a
    short chain of composites per step."""
    return _FEW_WARPS if n_blocks >= 4 * n_sms else _MANY_WARPS


def _warps(B: int, C: int, device) -> int:
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return block_warps(B * -(-C // _LANES), n_sms)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the maps ``h -> a h + b`` under
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, by doubling: log2(S)
    passes over the whole sequence."""
    S, k = a.shape[1], 1
    while k < S:
        a, b = (torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1),
                torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1))
        k *= 2
    return a, b


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                    chunk: int = SCAN_CHUNK):
    """Plain PyTorch version of :func:`linear_scan`, the reference's
    chunked scan: when S is a multiple of ``chunk`` and longer, a loop
    over chunks, each an associative scan started from the previous
    chunk's last value; else one associative scan.  Differentiable by
    autograd."""
    S = a.shape[1]
    if S % chunk != 0 or S <= chunk:
        A, Bc = _assoc_scan(a, b)
        h = A * h0[:, None] + Bc
        return h, h[:, -1]
    hs, h_prev = [], h0
    for s in range(0, S, chunk):
        A, Bc = _assoc_scan(a[:, s:s + chunk], b[:, s:s + chunk])
        hs.append(A * h_prev[:, None] + Bc)
        h_prev = hs[-1][:, -1]
    return torch.cat(hs, dim=1), h_prev


def linear_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                        g: torch.Tensor, g_last: torch.Tensor | None = None,
                        chunk: int = SCAN_CHUNK):
    """Plain PyTorch version of :func:`linear_scan_backward`: ``dh`` by
    :func:`linear_scan_ref` over the reversed sequence, with ``a``
    shifted by one step (``a[t + 1]`` carries ``dh[t + 1]`` into
    ``dh[t]``)."""
    if g_last is not None:
        g = torch.cat([g[:, :-1], (g[:, -1] + g_last)[:, None]], dim=1)
    coef = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    dh, _ = linear_scan_ref(coef.flip(1), g.flip(1), torch.zeros_like(h0),
                            chunk)
    dh = dh.flip(1)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    return dh * h_prev, dh, a[:, 0] * dh[:, 0]


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                chunk: int = SCAN_CHUNK):
    """``(h (B, S, C), h_last (B, C))`` of ``h_t = a_t h_{t-1} + b_t``
    from ``h0``; f32 throughout, contiguous on the card.  ``chunk`` is
    the plain version's (the kernel has its own tiling)."""
    B, S, C = _check("linear_scan", a=a, b=b, h0=h0)
    if not _on_cuda(a, b, h0):
        return linear_scan_ref(a, b, h0, chunk)
    _contiguous("linear_scan", a=a, b=b, h0=h0)
    h = torch.empty_like(a)
    if S == 0:
        return h, h0.clone()
    h_last = torch.empty_like(h0)
    from ._build import load_library

    rc = load_library("linear_scan").linear_scan_launch(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), B, S, C, _warps(B, C, a.device),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "linear_scan")
    LAUNCHES["linear_scan"] += 1
    return h, h_last


def linear_scan_backward(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                         g: torch.Tensor, g_last: torch.Tensor | None = None,
                         chunk: int = SCAN_CHUNK):
    """``(da, db (B, S, C), dh0 (B, C))`` of :func:`linear_scan`'s
    outputs ``h`` (saved by the forward) for ``g = dL/dh`` and ``g_last
    = dL/dh_last`` (None: zero).  On the card ``g`` as autograd hands it
    over is copied once if it is not contiguous."""
    B, S, C = _check("linear_scan_backward", a=a, h=h, g=g, h0=h0,
                     g_last=g_last)
    if not _on_cuda(a, h, h0, g, g_last):
        return linear_scan_bwd_ref(a, h, h0, g, g_last, chunk)
    g = g.contiguous()
    _contiguous("linear_scan_backward", a=a, h=h, h0=h0, g_last=g_last)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if S == 0:
        return da, db, (torch.zeros_like(h0) if g_last is None
                        else g_last.clone())
    dh0 = torch.empty_like(h0)
    from ._build import load_library

    rc = load_library("linear_scan").linear_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(), g.data_ptr(),
        None if g_last is None else g_last.data_ptr(), da.data_ptr(),
        db.data_ptr(), dh0.data_ptr(), B, S, C, _warps(B, C, a.device),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "linear_scan_bwd")
    LAUNCHES["linear_scan_bwd"] += 1
    return da, db, dh0


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0, chunk):
        h, h_last = linear_scan(a, b, h0, chunk)
        ctx.save_for_backward(a, h, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(h)
        da, db, dh0 = linear_scan_backward(a, h, h0, g, g_last, ctx.chunk)
        return da, db, dh0, None


def scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
         chunk: int = SCAN_CHUNK):
    """Differentiable :func:`linear_scan`: ``(h, h_last)`` with
    :func:`linear_scan_backward` as its gradient."""
    return _LinearScan.apply(a, b, h0, chunk)
