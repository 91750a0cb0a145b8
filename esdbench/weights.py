"""The benchmark's model weights, made on the device from ``--seed``.

Both the program and the reference receive these tensors: the program
as its model's parameters, the reference as its starting point (it
makes them again from the seed once the program has been freed).  Each
leaf, and each block of a table's rows, draws from a generator of its
own, so any block can be made again alone.  Each leaf is N(0, 1) times
its scale (zero where the scale is 0), the port's distributions: tables
0.01, products din ** -0.5, as the kind's module lists them.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.models import kind_of

__all__ = ["BLOCK_ROWS", "leaf_specs", "make_block", "make_leaf",
           "make_weights", "leaf_blocks"]

BLOCK_ROWS = 1 << 16


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, scale)`` of every leaf, in the order of the
    port's ``DLRM.named_parameters()``; scale 0 is a zero leaf.  The
    kind's module (``reference/models/<kind>.py``) lists them."""
    return kind_of(cfg).leaf_specs(cfg)


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
