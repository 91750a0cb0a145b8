"""The benchmark's model weights, made on the device from ``--seed``.

Both the program and the reference receive these tensors: the program
as its model's parameters, the reference as its starting point (it
makes them again from the seed once the program has been freed).  Each
leaf, and each block of a table's rows, draws from a generator of its
own, so any block can be made again alone.  The distributions are the
port's: tables N(0, 1) * 0.01, products N(0, 1) * din ** -0.5,
``cross_w`` N(0, 1) * d ** -0.5, ``cross_b`` zero.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BLOCK_ROWS", "leaf_specs", "make_block", "make_leaf",
           "make_weights", "leaf_blocks"]

BLOCK_ROWS = 1 << 16


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, scale)`` of every leaf, in the order of the
    port's ``DLRM.named_parameters()``; scale 0 is a zero leaf."""
    V, E = sum(cfg["table_sizes"]), cfg["embedding_dim"]
    F = len(cfg["table_sizes"])
    dims = list(cfg["mlp_dims"])
    specs = [("embed", (V, E), 0.01)]
    din = cfg["n_dense"]
    for i, dout in enumerate(dims + [E]):
        specs.append((f"bottom.{i}", (din, dout), din ** -0.5))
        din = dout
    din = E * (F + 2) if cfg["kind"] == "dcn" else E
    for i, dout in enumerate(dims + [1]):
        specs.append((f"top.{i}", (din, dout), din ** -0.5))
        din = dout
    if cfg["kind"] == "wdl":
        specs.append(("wide", (V, 1), 0.01))
    if cfg["kind"] == "dcn":
        d = E * (F + 2)
        specs.append(("cross_w", (cfg["cross_layers"], d), d ** -0.5))
        specs.append(("cross_b", (cfg["cross_layers"], d), 0.0))
    return specs


def _seed(seed: int, leaf: int, block: int) -> int:
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), leaf, block])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_block(seed: int, leaf: int, spec, block: int, device
               ) -> torch.Tensor:
    """Rows ``[block * BLOCK_ROWS, ...)`` of leaf ``leaf`` (f32)."""
    _, shape, scale = spec
    rows = min(BLOCK_ROWS, shape[0] - block * BLOCK_ROWS)
    if scale == 0.0:
        return torch.zeros((rows,) + tuple(shape[1:]), dtype=torch.float32,
                           device=device)
    g = torch.Generator(device=device).manual_seed(_seed(seed, leaf, block))
    out = torch.randn((rows,) + tuple(shape[1:]), generator=g,
                      dtype=torch.float32, device=device)
    return out.mul_(scale)


def leaf_blocks(seed: int, leaf: int, spec, device):
    """``(row0, block)`` of a leaf, block by block."""
    n_blocks = -(-spec[1][0] // BLOCK_ROWS)
    for b in range(n_blocks):
        yield b * BLOCK_ROWS, make_block(seed, leaf, spec, b, device)


def make_leaf(seed: int, leaf: int, spec, device) -> torch.Tensor:
    out = torch.empty(spec[1], dtype=torch.float32, device=device)
    for r0, blk in leaf_blocks(seed, leaf, spec, device):
        out[r0:r0 + blk.shape[0]] = blk
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every leaf by name, on ``device``."""
    return {spec[0]: make_leaf(seed, i, spec, device)
            for i, spec in enumerate(leaf_specs(cfg))}
