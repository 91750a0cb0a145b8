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
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["bag_sizes", "record_width", "zipf_ids", "CTRStream",
           "stream", "first_batches"]


def bag_sizes(cfg: dict) -> tuple:
    """Ids a sample in each field: the configuration's ``bag_sizes``,
    one a field where it has none."""
    return tuple(int(b) for b in
                 cfg.get("bag_sizes", [1] * len(cfg["table_sizes"])))


def record_width(cfg: dict) -> int:
    """Id slots a sample: every field's bag, then the history bag."""
    return sum(bag_sizes(cfg)) + int(cfg["hist_max"])


@lru_cache(maxsize=None)
def _cdf(a: float, vocab: int) -> np.ndarray:
    """The truncated power law's CDF, built once a (skew, size): the
    draws are the port's, without its CDF a table a batch (which keeps
    the loader thread, and the interpreter lock, busy)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-a))
    cdf /= cdf[-1]
    cdf.flags.writeable = False
    return cdf


def zipf_ids(rng: np.random.Generator, a: float, size: int,
             vocab: int) -> np.ndarray:
    """Zipf(a) truncated to [0, vocab): rank-frequency sampling."""
    u = rng.random(size)
    return np.searchsorted(_cdf(a, vocab), u).astype(np.int64)


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

    def sample_batch(self, rng: np.random.Generator, batch: int
                     ) -> np.ndarray:
        off = self.offsets()
        groups = rng.integers(0, self.n_groups, batch)
        cols = []
        for f in range(self.n_fields):
            size, b = self.table_sizes[f], self.bag_sizes[f]
            ids = zipf_ids(rng, self.zipf_a[f], batch * b, size)
            if size >= 10 * self.n_groups and self.group_frac > 0:
                slice_size = size // self.n_groups
                local = zipf_ids(rng, self.zipf_a[f], batch * b, slice_size)
                local = np.repeat(groups, b) * slice_size + local
                use_local = rng.random(batch * b) < self.group_frac
                ids = np.where(use_local, local, ids)
            cols.append(ids.reshape(batch, b) + off[f])
        out = np.concatenate(cols, axis=1)
        if self.hist_max:
            size = self.table_sizes[0]
            L = np.minimum(rng.geometric(1.0 / self.hist_mean, batch),
                           self.hist_max)
            hist = zipf_ids(rng, self.zipf_a[0], batch * self.hist_max, size)
            if size >= 10 * self.n_groups and self.group_frac > 0:
                slice_size = size // self.n_groups
                local = zipf_ids(rng, self.zipf_a[0], batch * self.hist_max,
                                 slice_size)
                local = np.repeat(groups, self.hist_max) * slice_size + local
                use_local = rng.random(batch * self.hist_max) < self.group_frac
                hist = np.where(use_local, local, hist)
            hist = hist.reshape(batch, self.hist_max) + off[0]
            hist[np.arange(self.hist_max)[None, :] >= L[:, None]] = -1
            out = np.concatenate([out, hist], axis=1)
        return out

    def batches(self, seed, batch: int):
        """The infinite stream of (sparse int32, dense, labels) batches
        that ``seed`` (any whole number, or a list of them) gives."""
        rng = np.random.default_rng(seed)
        while True:
            sparse = self.sample_batch(rng, batch).astype(np.int32)
            dense = rng.standard_normal((batch, self.n_dense)
                                        ).astype(np.float32)
            labels = (rng.random(batch) < 0.25).astype(np.float32)
            yield sparse, dense, labels


def stream(cfg: dict, mix: dict, seed: int):
    """A cell's batches for ``--seed`` (any whole number): k = workers x
    batch_per_worker samples a step, the ids, dense features and labels
    all drawn from the seed."""
    k = mix["workers"] * mix["batch_per_worker"]
    return CTRStream(cfg, mix).batches([int(seed) & (2 ** 64 - 1), 1], k)


def first_batches(cfg: dict, mix: dict, seed: int, steps: int) -> list:
    it = stream(cfg, mix, seed)
    return [next(it) for _ in range(steps)]
