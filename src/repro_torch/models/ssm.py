"""SSM mixers: the Mamba-1 selective scan (falcon-mamba) and the RG-LRU
(griffin, recurrentgemma), for training and prefill over the sequence
and as O(1)-state single-token decode steps.

The counterpart of the JAX package's ``models/ssm.py``, with its names
and its casts: ``dt``, ``B``, ``C``, the recurrence's ``a`` and ``b`` and
the state are f32, the output goes back to the activation dtype before
the gate.  Parameters are modules (:class:`Mamba`, :class:`RGLRU`) whose
attributes are the reference's leaves; a linear weight is ``(din,
dout)`` and its reference leaf ``{"w"}`` (``LINEARS`` names them).

The recurrence ``h_t = a_t h_{t-1} + b_t`` runs through
:func:`chunked_linear_scan`: on the card one launch of the linear-scan
kernel forward and one backward (:mod:`repro_torch.kernels.linear_scan`),
on the CPU its plain version, the reference's chunked doubling scan.  As
in the reference, Mamba materialises its (B, S, d_inner, N) ``a``,
``b`` and ``h`` (a fused selective scan is ROADMAP queue B work).
Decode steps write their cache in place, as the KV cache is written.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.linear_scan import SCAN_CHUNK, scan
from . import scan_config
from .layers import _gelu, init_linear, linear

__all__ = ["SCAN_CHUNK", "RG_C", "causal_conv1d", "conv_step",
           "chunked_linear_scan", "Mamba", "init_mamba", "mamba_block",
           "init_mamba_cache", "mamba_step", "RGLRU", "init_rglru",
           "rglru_block", "init_rglru_cache", "rglru_step"]

RG_C = 8.0


# --------------------------------------------------------------------------
# causal depthwise conv1d (shared by mamba and rglru)
# --------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b=None):
    """x: (B, S, C), w: (K, C) depthwise kernel; left-padded causal conv
    as the reference's K shifted multiply-adds (not ``F.conv1d``, which
    sums in cuDNN's order)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    if b is not None:
        out = out + b[None, None, :]
    return out


def conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b=None):
    """One decode step.  state: (B, K-1, C), x_t: (B, C) -> (out (B, C),
    the new state (B, K-1, C))."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)        # (B, K, C)
    out = (window * w[None]).sum(dim=1)
    if b is not None:
        out = out + b[None, :]
    return out, window[:, 1:, :]


# --------------------------------------------------------------------------
# the linear recurrence h_t = a_t h_{t-1} + b_t
# --------------------------------------------------------------------------
def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int | None = None):
    """Solve ``h_t = a_t h_{t-1} + b_t`` over axis 1 (S).  a, b: (B, S,
    ...) of one shape (the blocks' terms), h0: (B, ...).  Returns (h (B,
    S, ...), h_last (B, ...)).  The trailing axes are flattened into the
    kernel's C; ``chunk`` shapes the plain version's summation order
    only.  None is the reference's ``SCAN_CHUNK``, or under
    ``scan_config.UNROLL`` (the dry run's cost probes) S //
    ``PROBE_INNER_STEPS`` when that is larger, as the reference's."""
    B, S = a.shape[:2]
    C = math.prod(a.shape[2:])
    if chunk is None:
        chunk = SCAN_CHUNK
        if scan_config.UNROLL:   # cost probes: fewer, bigger chunks
            chunk = max(SCAN_CHUNK, S // scan_config.PROBE_INNER_STEPS)
    h, h_last = scan(a.reshape(B, S, C).contiguous(),
                     b.reshape(B, S, C).contiguous(),
                     h0.reshape(B, C).contiguous(), chunk)
    return h.reshape(a.shape), h_last.reshape(h0.shape)


# --------------------------------------------------------------------------
# Mamba-1 block
# --------------------------------------------------------------------------
class Mamba(nn.Module):
    """``in_proj (D, 2 di)``, ``conv_w (K, di)``, ``conv_b (di,)``,
    ``x_dt (di, dt_rank)``, ``dt_proj (dt_rank, di)``, ``dt_bias (di,)``,
    ``x_B``/``x_C (di, N)``, ``A_log (di, N)`` and ``D (di,)`` in f32,
    ``out_proj (di, D)``."""

    LINEARS = ("in_proj", "x_dt", "dt_proj", "x_B", "x_C", "out_proj")
    LEAVES = ("in_proj", "conv_w", "conv_b", "x_dt", "dt_proj", "dt_bias",
              "x_B", "x_C", "A_log", "D", "out_proj")

    def __init__(self, **leaves):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, nn.Parameter(leaves[name]))


def init_mamba(cfg: ModelConfig, dtype, *, generator: torch.Generator,
               device) -> Mamba:
    """The reference's distributions: the linears N(0, 1) * din**-0.5,
    ``conv_w`` N(0, 1) * 0.2, ``conv_b`` zero, ``dt_bias`` -4
    (softplus^-1 of a small dt), ``A_log`` log(1..N) per row (S4D-real)
    and ``D`` ones, both f32; the rest in ``dtype``."""
    d, N = cfg.d_model, cfg.ssm_state
    di = cfg.expand * d
    dt_rank = max(d // 16, 1)

    def lin(din, dout):
        return init_linear(din, dout, generator=generator,
                           device=device).to(dtype)

    in_proj = lin(d, 2 * di)
    conv_w = (torch.randn((cfg.d_conv, di), generator=generator,
                          device=device, dtype=torch.float32) * 0.2).to(dtype)
    x_dt, dt_proj = lin(di, dt_rank), lin(dt_rank, di)
    x_B, x_C, out_proj = lin(di, N), lin(di, N), lin(di, d)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return Mamba(in_proj=in_proj, conv_w=conv_w,
                 conv_b=torch.zeros((di,), dtype=dtype, device=device),
                 x_dt=x_dt, dt_proj=dt_proj,
                 dt_bias=torch.full((di,), -4.0, dtype=dtype, device=device),
                 x_B=x_B, x_C=x_C, A_log=torch.log(A).repeat(di, 1),
                 D=torch.ones((di,), dtype=torch.float32, device=device),
                 out_proj=out_proj)


def _mamba_inner(p: Mamba, xc: torch.Tensor):
    """xc: (B, S, di) after the conv and silu -> the scan's a, b (B, S,
    di, N) and C (B, S, N), all f32."""
    dt = F.softplus(linear(p.dt_proj, linear(p.x_dt, xc)).float()
                    + p.dt_bias.float())                       # (B, S, di)
    Bm = linear(p.x_B, xc).float()                             # (B, S, N)
    Cm = linear(p.x_C, xc).float()                             # (B, S, N)
    A = -torch.exp(p.A_log)                                    # (di, N)
    a = torch.exp(dt[..., None] * A[None, None])
    b = dt[..., None] * Bm[..., None, :] * xc.float()[..., None]
    return a, b, Cm


def mamba_block(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    """Train and prefill.  x: (B, S, D) -> (B, S, D)."""
    B = x.shape[0]
    di = cfg.expand * cfg.d_model
    xi, z = torch.chunk(linear(p.in_proj, x), 2, dim=-1)
    xc = F.silu(causal_conv1d(xi, p.conv_w.to(xi.dtype),
                              p.conv_b.to(xi.dtype)))
    a, b, Cm = _mamba_inner(p, xc)
    h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    h, _ = chunked_linear_scan(a, b, h0)                       # (B,S,di,N)
    y = torch.einsum("bsdn,bsn->bsd", h, Cm)
    y = y + xc.float() * p.D[None, None]
    y = y.to(x.dtype) * F.silu(z)
    return linear(p.out_proj, y)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """``{conv: (B, K-1, di) in dtype, ssm: (B, di, N) f32}``, zeros."""
    di = cfg.expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def mamba_step(p: Mamba, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Decode.  x: (B, 1, D) -> ((B, 1, D), cache), the cache's conv
    window and state written in place."""
    xi, z = torch.chunk(linear(p.in_proj, x[:, 0]), 2, dim=-1)
    xc, conv_state = conv_step(cache["conv"], xi, p.conv_w.to(xi.dtype),
                               p.conv_b.to(xi.dtype))
    xc = F.silu(xc)
    a, b, Cm = _mamba_inner(p, xc[:, None])
    h = a[:, 0] * cache["ssm"] + b[:, 0]                       # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = y + xc.float() * p.D[None]
    y = y.to(x.dtype) * F.silu(z)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return linear(p.out_proj, y)[:, None], cache


# --------------------------------------------------------------------------
# RG-LRU recurrent block (griffin / recurrentgemma)
# --------------------------------------------------------------------------
class RGLRU(nn.Module):
    """``in_x``/``in_gate (D, w)``, ``conv_w (K, w)``, ``gate_a``/
    ``gate_x (w, w)``, ``Lambda (w,)`` in f32, ``out (w, D)``."""

    LINEARS = ("in_x", "in_gate", "gate_a", "gate_x", "out")
    LEAVES = ("in_x", "in_gate", "conv_w", "gate_a", "gate_x", "Lambda",
              "out")

    def __init__(self, **leaves):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, nn.Parameter(leaves[name]))


def init_rglru(cfg: ModelConfig, dtype, *, generator: torch.Generator,
               device) -> RGLRU:
    """The reference's distributions: the linears N(0, 1) * din**-0.5,
    ``conv_w`` N(0, 1) * 0.2, and ``Lambda`` (f32) such that ``a =
    sigmoid(Lambda)**c`` is uniform in [0.9, 0.999]."""
    d = cfg.d_model
    w = cfg.lru_width or d

    def lin(din, dout):
        return init_linear(din, dout, generator=generator,
                           device=device).to(dtype)

    in_x, in_gate = lin(d, w), lin(d, w)
    conv_w = (torch.randn((cfg.d_conv, w), generator=generator,
                          device=device, dtype=torch.float32) * 0.2).to(dtype)
    gate_a, gate_x = lin(w, w), lin(w, w)
    u = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=device,
                                 dtype=torch.float32)
    lam = torch.log(u ** (1.0 / RG_C) / (1.0 - u ** (1.0 / RG_C)))
    return RGLRU(in_x=in_x, in_gate=in_gate, conv_w=conv_w, gate_a=gate_a,
                 gate_x=gate_x, Lambda=lam, out=lin(w, d))


def _rglru_terms(p: RGLRU, xc: torch.Tensor):
    """The recurrence's a and b (f32) for the conv's output xc."""
    r = torch.sigmoid(linear(p.gate_a, xc).float())
    i = torch.sigmoid(linear(p.gate_x, xc).float())
    log_a = -RG_C * r * F.softplus(-p.Lambda.float())[None]
    a = torch.exp(log_a)
    gated = i * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return a, b


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig):
    """Train and prefill: conv1d, RG-LRU and the GeLU gate.  x: (B, S, D)
    -> (B, S, D)."""
    B = x.shape[0]
    w = cfg.lru_width or cfg.d_model
    xi = linear(p.in_x, x)
    gate = _gelu(linear(p.in_gate, x))
    xc = causal_conv1d(xi, p.conv_w.to(xi.dtype))
    a, b = _rglru_terms(p, xc)
    h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    h, _ = chunked_linear_scan(a, b, h0)                       # (B, S, w)
    return linear(p.out, h.to(x.dtype) * gate)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """``{conv: (B, K-1, w) in dtype, h: (B, w) f32}``, zeros."""
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def rglru_step(p: RGLRU, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Decode.  x: (B, 1, D) -> ((B, 1, D), cache), written in place."""
    xi = linear(p.in_x, x[:, 0])
    gate = _gelu(linear(p.in_gate, x[:, 0]))
    xc, conv_state = conv_step(cache["conv"], xi, p.conv_w.to(xi.dtype))
    a, b = _rglru_terms(p, xc)
    h = a * cache["h"] + b
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return linear(p.out, h.to(x.dtype) * gate)[:, None], cache
