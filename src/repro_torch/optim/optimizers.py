"""Functional optimizers: SGD and row-wise Adagrad (the DLRM standard).

The counterpart of the JAX package's ``optim/optimizers.py``: (init,
update) pairs over a list of parameter tensors.  Row-wise Adagrad keeps
ONE accumulator per row of every parameter with two or more dimensions
(everything but the trailing dim is the row: the embedding table's
``(V, E)`` rows and the MLP weights' ``din`` rows in the ``(din, dout)``
layout) and one per element of a one-dimensional parameter.  ``update``
returns new tensors and leaves its inputs alone; the training driver
copies them into the model's parameters.  Adam comes with the LM side.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Optimizer", "sgd", "rowwise_adagrad", "get_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[list], list]
    update: Callable[[list, list, list], tuple[list, list]]  # (g, s, p)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return []

    def update(grads, state, params):
        new = [(p.float() - lr * g.float()).to(p.dtype)
               for p, g in zip(params, grads)]
        return new, state

    return Optimizer(init, update)


def rowwise_adagrad(lr: float = 1e-2, eps: float = 1e-10) -> Optimizer:
    """One accumulator per row for >= 2-D params, per element for 1-D."""

    def init(params):
        return [torch.zeros(p.shape[:-1] if p.dim() >= 2 else p.shape,
                            dtype=torch.float32, device=p.device)
                for p in params]

    def update(grads, state, params):
        new, accs = [], []
        for p, g, a in zip(params, grads, state):
            g = g.float()
            if p.dim() >= 2:
                a_new = a + torch.mean(g * g, dim=-1)
                upd = g * torch.rsqrt(a_new + eps)[..., None]
            else:
                a_new = a + g * g
                upd = g * torch.rsqrt(a_new + eps)
            new.append((p.float() - lr * upd).to(p.dtype))
            accs.append(a_new)
        return new, accs

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "adam":
        raise NotImplementedError("adam comes with the LM side of the port "
                                  "(ROADMAP A14)")
    return {"sgd": sgd, "rowwise_adagrad": rowwise_adagrad}[name](lr)
