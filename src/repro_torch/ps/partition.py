"""V-space partition over multiple parameter servers (the addressing layer).

The paper's edge setting has workers pulling embeddings from one or more
parameter servers; everything in ``repro.core`` historically indexed a
monolithic id space ``[0, V)`` held by a single PS.  :class:`PsPartition`
is the descriptor that splits that space across ``n_ps`` servers and owns
every translation the other layers need:

  * ``global_to_local(id) -> (ps_shard, local_row)`` and its inverse
    ``local_to_global`` — who owns an id, and where it lives on that
    server;
  * ``to_linear`` / ``from_linear`` — the *PS-linearized* space
    ``lin = shard * max_rows + local`` in ``[0, n_ps * max_rows)``.
    Linearization is how the partition threads through the existing
    engines without rewriting them: every (n, V) state plane, padded
    ``need_ids_list`` row, and embedding-table row index simply moves to
    the linear space, where the segment ``[p*max_rows, (p+1)*max_rows)``
    is exactly the set of rows PS ``p`` tracks.  With ``n_ps == 1`` the
    translation is the identity (``max_rows == vocab``), so the single-PS
    engines are bit-for-bit the special case.

Two layouts:

  * ``"contiguous"`` — per-shard row ranges ``bounds[p] <= id <
    bounds[p+1]`` (supports custom uneven ranges, e.g. one big table per
    PS);
  * ``"hashed"``     — ``shard = id % n_ps``, ``local = id // n_ps``
    (spreads Zipf head ids evenly across servers).

All translations are pure arithmetic on hashable Python ints, so a
``PsPartition`` is hashable and frozen, and every method accepts numpy arrays *or* torch tensors (the array
namespace is picked from the input; a tensor's results stay on its
device).  PAD ids (-1) translate to PAD:
``global_to_local(-1) == (0, -1)`` and ``to_linear(-1) == -1``, so the
padded-sample conventions of the dispatch layer survive translation.

A port of the JAX package's ``ps/partition.py``: the numpy arithmetic is
the reference's, line for line; where the reference picks ``jnp`` for a
traced array, this module picks torch for a tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PsPartition", "make_partition"]


class _TorchNS:
    """The few numpy calls of this module, over torch tensors."""

    @staticmethod
    def maximum(x, v):
        return x.clamp(min=v)

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def asarray(seq, dtype, device):
        return torch.as_tensor(seq, dtype=dtype, device=device)

    @staticmethod
    def searchsorted_right(b, x):
        return torch.searchsorted(b, x, right=True).to(x.dtype)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)


class _NumpyNS:
    maximum = staticmethod(np.maximum)
    where = staticmethod(np.where)
    zeros_like = staticmethod(np.zeros_like)

    @staticmethod
    def asarray(seq, dtype, device):
        return np.asarray(seq, dtype=dtype)

    @staticmethod
    def searchsorted_right(b, x):
        return np.searchsorted(b, x, side="right").astype(x.dtype)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)


def _xp(x):
    """numpy or torch, matching the input array."""
    return _TorchNS if isinstance(x, torch.Tensor) else _NumpyNS


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else None


@dataclasses.dataclass(frozen=True)
class PsPartition:
    """Partition of the global id space [0, vocab) over n_ps servers.

    Hashable and frozen.
    """

    vocab: int
    n_ps: int
    layout: str = "contiguous"            # "contiguous" | "hashed"
    bounds: tuple[int, ...] | None = None  # contiguous: len n_ps+1, [0..vocab]

    def __post_init__(self):
        if self.n_ps < 1:
            raise ValueError(f"n_ps must be >= 1, got {self.n_ps}")
        if self.layout == "contiguous":
            if self.bounds is None:
                q, r = divmod(self.vocab, self.n_ps)
                sizes = [q + 1] * r + [q] * (self.n_ps - r)
                bounds = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
                object.__setattr__(self, "bounds", bounds)
            b = self.bounds
            if (len(b) != self.n_ps + 1 or b[0] != 0 or b[-1] != self.vocab
                    or any(b[i] > b[i + 1] for i in range(self.n_ps))):
                raise ValueError(f"bad contiguous bounds {b} for "
                                 f"vocab={self.vocab}, n_ps={self.n_ps}")
        elif self.layout == "hashed":
            if self.bounds is not None:
                raise ValueError("hashed layout takes no bounds")
        else:
            raise ValueError(f"unknown layout {self.layout!r}")

    # -- static geometry -----------------------------------------------------
    def rows(self, shard: int) -> int:
        """Number of rows PS ``shard`` owns."""
        if self.layout == "contiguous":
            return self.bounds[shard + 1] - self.bounds[shard]
        return (self.vocab - shard + self.n_ps - 1) // self.n_ps

    @property
    def max_rows(self) -> int:
        """Rows of the largest shard — the per-PS plane/table height."""
        if self.n_ps == 1:
            return self.vocab
        return max(self.rows(p) for p in range(self.n_ps))

    @property
    def linear_size(self) -> int:
        """Size of the PS-linearized id space (n_ps * max_rows >= vocab)."""
        return self.n_ps * self.max_rows

    # -- translations --------------------------------------------------------
    def shard_of(self, ids):
        """Owning shard per id (PAD -> 0; mask separately)."""
        xp = _xp(ids)
        safe = xp.maximum(ids, 0)
        if self.layout == "hashed":
            return safe % self.n_ps
        b = xp.asarray(self.bounds[1:-1], safe.dtype, _device(safe))
        return xp.searchsorted_right(b, safe)

    def global_to_local(self, ids):
        """(shard, local_row) per id; PAD (-1) -> (0, -1)."""
        xp = _xp(ids)
        valid = ids >= 0
        safe = xp.where(valid, ids, 0)
        shard = self.shard_of(safe)
        if self.layout == "hashed":
            local = safe // self.n_ps
        else:
            b = xp.asarray(self.bounds, safe.dtype, _device(safe))
            local = safe - b[shard]
        return (xp.astype(xp.where(valid, shard, 0), safe.dtype),
                xp.where(valid, local, -1))

    def local_to_global(self, shard, local):
        """Inverse of :meth:`global_to_local` (local -1 -> -1)."""
        xp = _xp(local)
        valid = local >= 0
        safe = xp.where(valid, local, 0)
        if self.layout == "hashed":
            g = safe * self.n_ps + shard
        else:
            b = xp.asarray(self.bounds, safe.dtype, _device(safe))
            g = b[shard] + safe
        return xp.where(valid, g, -1)

    def to_linear(self, ids):
        """Global id -> PS-linearized id (PAD preserved).

        Identity when ``n_ps == 1``: shard 0, ``max_rows == vocab``.
        """
        if self.n_ps == 1:
            return ids
        shard, local = self.global_to_local(ids)
        xp = _xp(ids)
        return xp.where(local >= 0, shard * self.max_rows + local, -1)

    def from_linear(self, lin):
        """PS-linearized id -> global id (PAD preserved)."""
        if self.n_ps == 1:
            return lin
        xp = _xp(lin)
        valid = lin >= 0
        safe = xp.where(valid, lin, 0)
        g = self.local_to_global(safe // self.max_rows, safe % self.max_rows)
        return xp.where(valid, g, -1)

    def shard_of_linear(self, lin):
        """Owning shard of a PS-linearized id (PAD -> 0)."""
        if self.n_ps == 1:
            xp = _xp(lin)
            return xp.zeros_like(lin)
        xp = _xp(lin)
        return xp.maximum(lin, 0) // self.max_rows

    # -- convenience ---------------------------------------------------------
    @classmethod
    def identity(cls, vocab: int) -> "PsPartition":
        """The single-PS special case (identity translation)."""
        return cls(vocab, 1)

    @classmethod
    def contiguous(cls, vocab: int, n_ps: int,
                   bounds: tuple[int, ...] | None = None) -> "PsPartition":
        return cls(vocab, n_ps, "contiguous", bounds)

    @classmethod
    def hashed(cls, vocab: int, n_ps: int) -> "PsPartition":
        return cls(vocab, n_ps, "hashed")


def make_partition(vocab: int, n_ps: int,
                   layout: str = "contiguous") -> PsPartition:
    """Factory used by SimConfig / the train driver CLI (unknown layout
    strings hit PsPartition's own validation)."""
    return PsPartition(vocab, n_ps, layout)
