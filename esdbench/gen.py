"""The benchmark's traffic generator: a frozen copy of the CTR stream
the port draws (Zipf ids over per-field tables with group locality, an
optional multi-hot history bag, dense features, labels), widened to a
bag of ids a field.

It takes the record's shape (the tables, the ids a field, the dense
width, the history slots) from a configuration file, the key
distribution (each field's Zipf skew by its table's size, the user
groups) from a traffic mix and its seed from the command line, so the
program under test receives only the arrays.  With one id a field the
stream is the port's, draw for draw.

A batch is made in two parts: :meth:`CTRStream.draw` takes every random
number the batch uses from the generator, in the port's order, and
:meth:`CTRStream.assemble` turns them into the arrays.  No draw depends
on a lookup, so a process that only draws can run ahead of those that
look up (``feed.py``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["bag_sizes", "record_width", "seed_words", "Zipf", "zipf",
           "CTRStream"]


def bag_sizes(cfg: dict) -> tuple:
    """Ids a sample in each field: the configuration's ``bag_sizes``,
    one a field where it has none."""
    return tuple(int(b) for b in
                 cfg.get("bag_sizes", [1] * len(cfg["table_sizes"])))


def record_width(cfg: dict) -> int:
    """Id slots a sample: every field's bag, then the history bag."""
    return sum(bag_sizes(cfg)) + int(cfg["hist_max"])


def seed_words(seed: int) -> list:
    """The generator's seed for ``--seed`` (any whole number)."""
    return [int(seed) & (2 ** 64 - 1), 1]


class Zipf:
    """Zipf(a) truncated to [0, vocab) by rank-frequency sampling: a
    uniform u gives the number of the truncated power law's CDF entries
    below it, ``np.searchsorted(cdf, u)`` (side left), the port's id.

    Found through a guide table over G = 2**k >= vocab buckets: u * G is
    exact, so the entries below u lie between the entries below
    floor(u G) / G and below (floor(u G) + 1) / G, and a bisection over
    that bucket ends the search.  Most buckets hold at most one entry;
    the deep tail's hold a few dozen."""

    def __init__(self, a: float, vocab: int):
        if not 0 < vocab < 2 ** 31:
            raise ValueError(f"vocab {vocab}: 1 to 2**31 - 1 ids")
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** (-a))
        cdf /= cdf[-1]
        self.cdf = cdf
        self.G = 1 << int(vocab - 1).bit_length()
        # an entry c lies below b / G exactly when floor(c G) + 1 <= b
        first = np.floor(cdf * self.G).astype(np.int64) + 1
        self.guide = np.cumsum(np.bincount(first, minlength=self.G + 2)
                               [:self.G + 1]).astype(np.int32)
        self.iters = int(np.diff(self.guide).max()).bit_length()

    def ids(self, u: np.ndarray) -> np.ndarray:
        b = (u * self.G).astype(np.int64)
        lo, hi = self.guide[b], self.guide[b + 1]
        open_ = np.flatnonzero(lo < hi)
        if open_.size:
            l, h, v = lo[open_], hi[open_], u[open_]
            for _ in range(self.iters):
                mid = (l + h) >> 1
                below = self.cdf[mid] < v
                l = np.where(below, mid + 1, l)
                h = np.where(below, h, mid)
            lo[open_] = l
        return lo.astype(np.int64)


@lru_cache(maxsize=None)
def zipf(a: float, vocab: int) -> Zipf:
    """One sampler a (skew, size), built on first use."""
    return Zipf(a, vocab)


class CTRStream:
    """Sparse (k, record_width) flat ids, PAD -1, dense (k, n_dense) f32
    and labels (k,) f32, drawn batch by batch from one numpy generator.
    A sample's columns are field 0's bag, field 1's, ..., then its
    history bag; every id of a sample draws from its user group."""

    def __init__(self, cfg: dict, mix: dict):
        self.table_sizes = tuple(int(v) for v in cfg["table_sizes"])
        self.bag_sizes = bag_sizes(cfg)
        if len(self.bag_sizes) != len(self.table_sizes) or \
                min(self.bag_sizes) < 1:
            raise ValueError(f"bag_sizes {self.bag_sizes}: one size of 1 "
                             f"or more a table")
        self.zipf_a = tuple(
            float(mix["zipf_a_large"] if size >= mix["large_table_rows"]
                  else mix["zipf_a_small"]) for size in self.table_sizes)
        self.n_dense = int(cfg["n_dense"])
        self.n_groups = int(mix["n_groups"])
        self.group_frac = float(mix["group_frac"])
        self.hist_max = int(cfg["hist_max"])
        self.hist_mean = float(mix.get("hist_mean", 0.0))

    @property
    def n_fields(self) -> int:
        return len(self.table_sizes)

    @property
    def vocab(self) -> int:
        return int(sum(self.table_sizes))

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.table_sizes)[:-1]]
                              ).astype(np.int64)

    def _local(self, f: int) -> bool:
        """Whether field f's ids may come from the group's slice."""
        return self.table_sizes[f] >= 10 * self.n_groups and \
            self.group_frac > 0

    def _uniforms(self, rng, f: int, n: int) -> tuple:
        """A bag's uniforms: the table's, then, for a grouped field, the
        slice's and the choice between them."""
        return tuple(rng.random(n) for _ in range(3 if self._local(f)
                                                  else 1))

    def draw(self, rng: np.random.Generator, batch: int) -> tuple:
        """Every number one batch uses, in the order the stream draws
        them: the samples' groups, each field's uniforms, the history
        bags' lengths and uniforms, the dense features, the labels'
        uniforms."""
        groups = rng.integers(0, self.n_groups, batch)
        fields = [self._uniforms(rng, f, batch * b)
                  for f, b in enumerate(self.bag_sizes)]
        hist = None
        if self.hist_max:
            lengths = rng.geometric(1.0 / self.hist_mean, batch)
            hist = (lengths,) + self._uniforms(rng, 0,
                                               batch * self.hist_max)
        dense = rng.standard_normal((batch, self.n_dense))
        return groups, fields, hist, dense, rng.random(batch)

    def _ids(self, f: int, uniforms: tuple, groups: np.ndarray,
             b: int) -> np.ndarray:
        size, a = self.table_sizes[f], self.zipf_a[f]
        if len(uniforms) == 1:
            return zipf(a, size).ids(uniforms[0]).reshape(groups.size, b)
        # each id from the table or from its group's slice: only the
        # uniform of the side it takes is looked up
        slice_size = size // self.n_groups
        local = uniforms[2] < self.group_frac
        mine, table = np.flatnonzero(local), np.flatnonzero(~local)
        ids = np.empty(local.size, np.int64)
        ids[table] = zipf(a, size).ids(uniforms[0][table])
        # slot p is sample p // b's
        ids[mine] = groups[mine // b] * slice_size + \
            zipf(a, slice_size).ids(uniforms[1][mine])
        return ids.reshape(groups.size, b)

    def assemble(self, numbers: tuple) -> tuple:
        """(sparse int32, dense f32, labels f32) from :meth:`draw`'s
        numbers."""
        groups, fields, hist, dense, labels = numbers
        off = self.offsets()
        sparse = np.empty((groups.size, sum(self.bag_sizes) + self.hist_max),
                          np.int32)
        col = 0
        for f, (u, b) in enumerate(zip(fields, self.bag_sizes)):
            sparse[:, col:col + b] = self._ids(f, u, groups, b) + off[f]
            col += b
        if hist is not None:
            lengths = np.minimum(hist[0], self.hist_max)
            bag = self._ids(0, hist[1:], groups, self.hist_max) + off[0]
            bag[np.arange(self.hist_max)[None, :] >= lengths[:, None]] = -1
            sparse[:, col:] = bag
        return (sparse, dense.astype(np.float32),
                (labels < 0.25).astype(np.float32))

    def batches(self, seed, batch: int):
        """The infinite stream of (sparse int32, dense, labels) batches
        that ``seed`` (any whole number, or a list of them) gives, drawn
        in this thread."""
        rng = np.random.default_rng(seed)
        while True:
            yield self.assemble(self.draw(rng, batch))
