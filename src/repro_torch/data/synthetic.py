"""Synthetic CTR workload streams (Criteo/Avazu-shaped) + LM token streams.

No public datasets ship with the repository, so the paper's workloads
S1 (WDL/Criteo-Kaggle), S2 (DFM/Avazu), S3 (DCN/Criteo-Sponsored) are
modeled by Zipfian categorical streams with the datasets' characteristic
shape: a handful of huge tables (1e5-1e6 ids) plus many small ones, ~26-39
sparse fields, heavy head reuse (Zipf a≈1.05-1.2).

The numpy logic is the JAX package's, line for line, so both packages
draw identical streams from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["CTRWorkload", "WORKLOADS", "zipf_ids", "token_stream"]


def zipf_ids(
    rng: np.random.Generator, a: float, size: int, vocab: int
) -> np.ndarray:
    """Zipf(a) truncated to [0, vocab): rank-frequency sampling."""
    # inverse-CDF on the truncated power law, cheap & reproducible
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** (-a)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(size)
    return np.searchsorted(cdf, u).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CTRWorkload:
    """A sparse-feature stream: F fields, each with its own table + skew.

    ``n_groups``/``group_frac`` model user/session locality: each sample
    belongs to a latent user group whose big-table ids concentrate in a
    group-specific slice.
    """

    name: str
    model: str                      # wdl | dfm | dcn  (paper Table 3)
    table_sizes: tuple[int, ...]    # ids per field
    zipf_a: tuple[float, ...]       # skew per field
    n_dense: int = 13
    n_groups: int = 32
    group_frac: float = 0.7        # share of big-table ids from the group slice
    # multi-hot user-history bag (variable length, PAD=-1)
    hist_max: int = 48
    hist_mean: float = 12.0

    @property
    def n_fields(self) -> int:
        return len(self.table_sizes)

    @property
    def width(self) -> int:
        """Columns of a sample row (fixed fields + history slots)."""
        return self.n_fields + self.hist_max

    @property
    def vocab(self) -> int:
        """Total id universe (fields are offset into one flat table)."""
        return int(sum(self.table_sizes))

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.table_sizes)[:-1]]).astype(np.int64)

    def sample_batch(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        """(batch, F) flat (offset) ids with per-sample group locality."""
        off = self.offsets()
        groups = rng.integers(0, self.n_groups, batch)
        cols = []
        for f in range(self.n_fields):
            size = self.table_sizes[f]
            ids = zipf_ids(rng, self.zipf_a[f], batch, size)
            if size >= 10 * self.n_groups and self.group_frac > 0:
                # group-local draw: same Zipf shape inside the group slice
                slice_size = size // self.n_groups
                local = zipf_ids(rng, self.zipf_a[f], batch, slice_size)
                local = groups * slice_size + local
                use_local = rng.random(batch) < self.group_frac
                ids = np.where(use_local, local, ids)
            cols.append(ids + off[f])
        out = np.stack(cols, axis=1)
        if self.hist_max:
            # variable-length multi-hot history over field 0's table
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

    def dense_batch(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        return rng.standard_normal((batch, self.n_dense)).astype(np.float32)

    def label_batch(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        return (rng.random(batch) < 0.25).astype(np.float32)

    def stream(
        self, seed: int, batch: int
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Infinite (sparse_ids, dense, labels) stream."""
        rng = np.random.default_rng(seed)
        while True:
            yield (
                self.sample_batch(rng, batch),
                self.dense_batch(rng, batch),
                self.label_batch(rng, batch),
            )


def _mk(name, model, big, small, n_big, n_small, a_big, a_small):
    return CTRWorkload(
        name=name,
        model=model,
        table_sizes=(big,) * n_big + (small,) * n_small,
        zipf_a=(a_big,) * n_big + (a_small,) * n_small,
    )


# Paper Table 3 stand-ins (shape-matched, see module docstring)
WORKLOADS: dict[str, CTRWorkload] = {
    "S1": _mk("S1", "wdl", big=120_000, small=1_000, n_big=4, n_small=22, a_big=1.25, a_small=1.1),
    "S2": _mk("S2", "dfm", big=80_000, small=500, n_big=5, n_small=17, a_big=1.35, a_small=1.1),
    "S3": _mk("S3", "dcn", big=150_000, small=2_000, n_big=3, n_small=23, a_big=1.2, a_small=1.15),
    # small variant for tests
    "tiny": _mk("tiny", "wdl", big=2_000, small=100, n_big=2, n_small=4, a_big=1.1, a_small=1.05),
}


def token_stream(
    seed: int, vocab: int, batch: int, seq_len: int, zipf_a: float = 1.1
) -> Iterator[np.ndarray]:
    """LM token batches (batch, seq_len) with Zipfian vocabulary reuse."""
    rng = np.random.default_rng(seed)
    while True:
        yield zipf_ids(rng, zipf_a, batch * seq_len, vocab).reshape(batch, seq_len)
