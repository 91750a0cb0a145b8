import torch


def mlp(P: dict, name: str, x: torch.Tensor, layers: int, mm):
    """x @ W_0, ReLU, ..., x @ W_last (no ReLU after the last)."""
    for i in range(layers):
        x = mm(x, P[f"{name}.{i}"])
        if i + 1 < layers:
            x = torch.relu(x)
    return x
