"""Bias-free linear layer in the JAX package's layout: the weight is
``(din, dout)`` and the forward is ``x @ w``."""
from __future__ import annotations

import torch

__all__ = ["linear", "init_linear"]


def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def init_linear(din: int, dout: int, *, generator: torch.Generator,
                device, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else din ** -0.5
    return torch.randn((din, dout), generator=generator, device=device,
                       dtype=torch.float32) * scale
