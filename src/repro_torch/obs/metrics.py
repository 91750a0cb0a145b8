"""Metrics registry: the subset of the JAX package's ``obs.metrics`` that
the serving and training drivers use (counters, gauges, histograms with
quantiles, and the training driver's per-step records)."""
from __future__ import annotations

import math
from typing import Any, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "STEP_NAMESPACE"]


class Counter:
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, amount=1):
        self.value += amount
        return self.value


class Gauge:
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, value):
        self.value = value
        return value


class Histogram:
    """Streaming histogram; ``keep=True`` retains raw samples."""

    __slots__ = ("name", "count", "sum", "min", "max", "samples")
    kind = "histogram"

    def __init__(self, name: str, keep: bool = False):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: Optional[list] = [] if keep else None

    def observe(self, value):
        self.count += 1
        self.sum += value
        v = float(value)
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if self.samples is not None:
            self.samples.append(value)
        return value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """The q-quantile (linear interpolation, numpy default) of the
        retained samples.  Needs ``keep=True``; an empty histogram
        returns NaN."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        if self.samples is None:
            raise TypeError(
                f"histogram {self.name!r} was created with keep=False; "
                f"quantiles need the retained samples (keep=True)")
        if not self.samples:
            return math.nan
        xs = sorted(float(v) for v in self.samples)
        if len(xs) == 1:
            return xs[0]
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac


# Driver per-step record field -> namespaced cumulative metric folded by
# record_step().  Byte/count fields accumulate into counters; rates and
# level-style fields land in gauges (last value wins).
STEP_NAMESPACE = {
    "cost": ("dispatch.cost_s", "counter"),
    "alg1_est": ("dispatch.alg1_cost", "gauge"),
    "miss_pull": ("cache.miss_pull", "counter"),
    "update_push": ("cache.update_push", "counter"),
    "evict_push": ("cache.evict_push", "counter"),
    "prefetch_bytes": ("prefetch.bytes", "counter"),
    "demand_miss_bytes": ("cache.demand_miss", "counter"),
    "prefetch_hit_rate": ("prefetch.hit_rate", "gauge"),
    "loss": ("train.loss", "gauge"),
    "wall_s": ("train.wall_s", "counter"),
}


class MetricsRegistry:
    """Namespaced metric store (create-on-first-use) plus the training
    driver's per-step records."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        # the training driver's list of per-step dicts
        self.steps: list[dict] = []

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, keep: bool = False) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, keep=keep)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a histogram")
        return m

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, "
                            f"not a {cls.kind}")
        return m

    def record_step(self, step: int, fields: dict) -> dict:
        """Append one per-step record and fold its fields into the
        namespaced cumulative metrics.  Returns the record."""
        rec = {"step": step, **fields}
        self.steps.append(rec)
        for key, value in fields.items():
            ns = STEP_NAMESPACE.get(key)
            if ns is None or value is None:
                continue
            name, kind = ns
            if kind == "counter":
                self.counter(name).inc(value)
            else:
                self.gauge(name).set(value)
        return rec
