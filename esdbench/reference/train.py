"""The reference training step: the BCE loss of a plain forward, its
gradient by autograd, and row-wise Adagrad (one accumulator a row of
every leaf, lr 1e-2, eps 1e-10), at a chosen dtype and product.

The tables are held compact: only the rows of ``universe`` (the ids the
followed batches touch), since no other row moves."""
from __future__ import annotations

import numpy as np
import torch

from .codec import fake_quant
from .models import kind_of

__all__ = ["TABLES", "plain_mm", "tf32_mm", "RefTrainer"]

TABLES = ("embed", "wide")
_EPS = 1e-10


def plain_mm(a, b):
    """The product at the operands' own precision (TF32 off)."""
    return a @ b


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 stored mantissa bits (to nearest, ties
    away from zero), kept in f32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A product, and the two products of its gradient, as the tensor
    cores take them in TF32: operands rounded to TF32, then multiplied
    and summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a.float()), _tf32(b.float())
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g.float())
        return g @ b.T, a.T @ g


def tf32_mm(a, b):
    return _TF32MatMul.apply(a, b)


class RefTrainer:
    def __init__(self, cfg: dict, weights: dict, universe: np.ndarray,
                 lr: float, dtype, mm, codec=None):
        self.cfg, self.lr, self.mm, self.codec = cfg, lr, mm, codec
        self.forward = kind_of(cfg).forward
        dev = weights["embed"].device
        self.universe = torch.as_tensor(np.asarray(universe, np.int64),
                                        device=dev)
        self.P = {}
        for name, w in weights.items():
            w = w[self.universe] if name in TABLES else w
            self.P[name] = w.to(dtype).clone().requires_grad_(True)
        self.P0 = {k: v.detach().clone() for k, v in self.P.items()}
        self.acc = {k: torch.zeros(v.shape[:-1], dtype=dtype, device=dev)
                    for k, v in self.P.items()}
        self.grad_norms = None
        # the quantized wire: each table's pushed gradient carries its
        # quantization error to the next step
        self.residual = {k: torch.zeros_like(v) for k, v in self.P.items()
                         if k in TABLES and codec is not None}

    def _remap(self, ids: torch.Tensor) -> torch.Tensor:
        valid = ids >= 0
        pos = torch.searchsorted(self.universe, ids.long().clamp(min=0))
        return torch.where(valid, pos, -1)

    def step(self, ids: torch.Tensor, dense: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        dt = self.P["embed"].dtype
        P = dict(self.P)
        for k in self.residual:
            # straight through: the rows as the wire delivers them, the
            # gradient of the identity
            v = P[k].detach()
            P[k] = P[k] + (fake_quant(v, self.codec) - v)
        z = self.forward(P, self._remap(ids), dense.to(dt), self.cfg,
                         self.mm)
        y = labels.to(dt)
        loss = torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-torch.abs(z))))
        names = list(self.P)
        grads = list(torch.autograd.grad(loss, [self.P[k] for k in names]))
        for i, k in enumerate(names):
            if k in self.residual:
                acc = grads[i] + self.residual[k]
                grads[i] = fake_quant(acc, self.codec)
                self.residual[k] = acc - grads[i]
        with torch.no_grad():
            for k, g in zip(names, grads):
                a = self.acc[k] + torch.mean(g * g, dim=-1)
                self.acc[k] = a
                self.P[k] -= self.lr * g * torch.rsqrt(a + _EPS)[..., None]
        if self.grad_norms is None:
            self.grad_norms = self.norms_from_acc()
        return loss.detach()

    def norms_from_acc(self) -> dict:
        """Each leaf's gradient norm as the optimizer's state holds it
        after one step: sqrt(row width * sum of the rows' mean squares)."""
        return {k: float(torch.sqrt(a.double().sum() * self.P[k].shape[-1]))
                for k, a in self.acc.items()}

    def change_norms(self) -> dict:
        return {k: float(torch.linalg.vector_norm(
                    (self.P[k].detach() - self.P0[k]).double()))
                for k in self.P}
