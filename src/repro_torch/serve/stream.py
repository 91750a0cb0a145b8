"""Request arrivals + continuous micro-batcher for the serving path.

Arrival process: a seeded inhomogeneous Poisson stream at ``qps`` with an
optional *flash crowd* (rate multiplied by ``burst_x`` inside a window)
and optional *Zipf drift*: every ``drift_period_s`` the hot head of each
big table rotates by a fixed stride.

Micro-batcher: requests enter an admission queue in arrival order; an
open batch closes when it reaches ``max_size`` requests OR when the
oldest queued request has waited ``max_wait_s``.  Batches come out
fixed-shape (padded to ``max_size`` with PAD rows).

The numpy logic is the JAX package's, so both packages replay the same
stream from one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..data.synthetic import CTRWorkload

__all__ = ["StreamConfig", "MicroBatch", "request_arrivals",
           "micro_batches"]

PAD_ID = -1


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """One serving episode's arrival process."""

    workload: CTRWorkload
    qps: float                       # mean request rate
    duration_s: float                # episode length
    seed: int = 0
    # flash crowd: rate *= burst_x inside [burst_at_s, burst_at_s + dur)
    burst_at_s: float | None = None
    burst_dur_s: float = 0.0
    burst_x: float = 1.0
    # Zipf drift: every period, each big table's id space rotates by
    # size // drift_stride_frac_inv (None = stationary popularity)
    drift_period_s: float | None = None
    drift_stride_frac_inv: int = 8

    def rate_at(self, t: float) -> float:
        if (self.burst_at_s is not None
                and self.burst_at_s <= t < self.burst_at_s + self.burst_dur_s):
            return self.qps * self.burst_x
        return self.qps


def _apply_drift(wl: CTRWorkload, rows: np.ndarray, epoch: np.ndarray,
                 stride_frac_inv: int) -> np.ndarray:
    """Rotate each request's ids inside their owning table by
    ``epoch * (size // stride_frac_inv)``.  PAD slots pass through."""
    off = wl.offsets()
    sizes = np.asarray(wl.table_sizes, np.int64)
    # column -> owning field: fixed fields map 1:1, history slots to 0
    field_of = np.concatenate([
        np.arange(wl.n_fields, dtype=np.int64),
        np.zeros(rows.shape[1] - wl.n_fields, np.int64),
    ])
    f = field_of[None, :]
    size = sizes[f]
    base = off[f]
    shift = (epoch[:, None] * (size // stride_frac_inv)) % np.maximum(size, 1)
    valid = rows != PAD_ID
    local = np.where(valid, rows - base, 0)
    out = base + (local + shift) % np.maximum(size, 1)
    return np.where(valid, out, PAD_ID)


def request_arrivals(cfg: StreamConfig):
    """The episode's requests: ``(t, sparse, dense)`` with ``t`` (R,)
    float64 arrival seconds (sorted), ``sparse`` (R, W) int64 flat ids
    (PAD = -1), ``dense`` (R, n_dense) f32.  Seeded and deterministic."""
    rng = np.random.default_rng(cfg.seed)
    # thinning against the peak rate gives an exact inhomogeneous Poisson
    peak = cfg.qps * max(1.0, cfg.burst_x if cfg.burst_at_s is not None
                         else 1.0)
    times = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= cfg.duration_s:
            break
        if rng.random() <= cfg.rate_at(t) / peak:
            times.append(t)
    t_arr = np.asarray(times, np.float64)
    R = len(t_arr)
    if R == 0:
        W = cfg.workload.width
        return (t_arr, np.zeros((0, W), np.int64),
                np.zeros((0, cfg.workload.n_dense), np.float32))
    sparse = cfg.workload.sample_batch(rng, R)
    dense = cfg.workload.dense_batch(rng, R)
    if cfg.drift_period_s is not None and cfg.drift_period_s > 0:
        epoch = (t_arr // cfg.drift_period_s).astype(np.int64)
        sparse = _apply_drift(cfg.workload, sparse, epoch,
                              cfg.drift_stride_frac_inv)
    return t_arr, sparse, dense


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One closed micro-batch: fixed ``max_size`` rows, the ``n`` real
    requests compacted first, PAD rows (ids = -1, t_arrive = inf) after."""

    t_close: float            # batch close time (dispatch decision time)
    n: int                    # valid request rows
    sparse: np.ndarray        # (max_size, W) int64, PAD = -1
    dense: np.ndarray         # (max_size, n_dense) f32
    t_arrive: np.ndarray      # (max_size,) float64, inf on PAD rows

    @property
    def valid(self) -> np.ndarray:
        return np.arange(len(self.t_arrive)) < self.n


def micro_batches(t_arr: np.ndarray, sparse: np.ndarray, dense: np.ndarray,
                  *, max_size: int, max_wait_s: float) -> list[MicroBatch]:
    """Close the arrival stream into micro-batches.

    A batch opens at its first request's arrival and closes at
    ``min(open_t + max_wait_s, arrival that fills it to max_size)``.
    """
    if max_size < 1:
        raise ValueError(f"max_size must be >= 1, got {max_size}")
    if max_wait_s < 0:
        raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
    out: list[MicroBatch] = []
    R = len(t_arr)
    W = sparse.shape[1] if R else 0
    D = dense.shape[1] if R else 0
    i = 0
    while i < R:
        open_t = t_arr[i]
        deadline = open_t + max_wait_s
        j = i + 1
        while j < R and j - i < max_size and t_arr[j] <= deadline:
            j += 1
        n = j - i
        t_close = float(t_arr[j - 1]) if n == max_size else float(deadline)
        sp = np.full((max_size, W), PAD_ID, np.int64)
        de = np.zeros((max_size, D), np.float32)
        ta = np.full((max_size,), np.inf, np.float64)
        sp[:n] = sparse[i:j]
        de[:n] = dense[i:j]
        ta[:n] = t_arr[i:j]
        out.append(MicroBatch(t_close=t_close, n=n, sparse=sp, dense=de,
                              t_arrive=ta))
        i = j
    return out
