"""Metrics registry: the subset of the JAX package's ``obs.metrics`` that
the serving driver uses (counters and histograms with quantiles)."""
from __future__ import annotations

import math
from typing import Any, Optional

__all__ = ["Counter", "Histogram", "MetricsRegistry"]


class Counter:
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, amount=1):
        self.value += amount
        return self.value


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


class MetricsRegistry:
    """Namespaced metric store (create-on-first-use)."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

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
