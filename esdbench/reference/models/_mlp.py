"""What every kind's MLPs share: their leaves, their operations and
their forward pass (products without biases, ReLU between)."""
import torch


def mlp_specs(name: str, din: int, dims) -> list:
    """``(name.i, (din_i, dout_i), din_i ** -0.5)`` a layer."""
    specs = []
    for i, dout in enumerate(dims):
        specs.append((f"{name}.{i}", (din, dout), din ** -0.5))
        din = dout
    return specs


def mlp_flops(din: int, dims) -> int:
    """2 din dout a layer: the products."""
    total = 0
    for dout in dims:
        total += 2 * din * dout
        din = dout
    return total


def mlp(P: dict, name: str, x: torch.Tensor, layers: int, mm):
    """x @ W_0, ReLU, ..., x @ W_last (no ReLU after the last)."""
    for i in range(layers):
        x = mm(x, P[f"{name}.{i}"])
        if i + 1 < layers:
            x = torch.relu(x)
    return x
