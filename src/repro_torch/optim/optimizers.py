"""Functional optimizers: SGD, Adam, row-wise Adagrad (the DLRM standard).

The counterpart of the JAX package's ``optim/optimizers.py``: (init,
update) pairs over a list of parameter tensors.  Row-wise Adagrad keeps
ONE accumulator per row of every parameter with two or more dimensions
(everything but the trailing dim is the row: the embedding table's
``(V, E)`` rows and the MLP weights' ``din`` rows in the ``(din, dout)``
layout) and one per element of a one-dimensional parameter.  ``update``
returns new tensors and leaves its inputs alone; the training driver
copies them into the model's parameters.  Adam drives the LM, with
f32 moments and f32 bias corrections, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Optimizer", "sgd", "adam", "rowwise_adagrad", "get_optimizer"]


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


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8) -> Optimizer:
    """Adam: ``mu`` and ``nu`` f32, the step count ``t`` int32, the bias
    corrections ``1 - b**t`` computed in f32; a parameter updates in f32
    and is cast back to its dtype."""

    def init(params):
        return {"mu": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
                "nu": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
                "t": torch.zeros((), dtype=torch.int32,
                                 device=params[0].device if params else None)}

    def update(grads, state, params):
        t = state["t"] + 1
        mu = [b1 * m + (1 - b1) * g.float()
              for m, g in zip(state["mu"], grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g.float())
              for v, g in zip(state["nu"], grads)]
        tf = t.float()
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=tf.device), tf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=tf.device), tf)
        new = [(p.float() - lr * ((m / c1) / (torch.sqrt(v / c2) + eps)))
               .to(p.dtype) for p, m, v in zip(params, mu, nu)]
        return new, {"mu": mu, "nu": nu, "t": t}

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
    return {"sgd": sgd, "adam": adam,
            "rowwise_adagrad": rowwise_adagrad}[name](lr)
