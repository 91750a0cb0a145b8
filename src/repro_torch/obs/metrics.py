"""Unified metrics registry for the ESD stack.

One namespaced schema — ``exchange.wire_bytes``, ``cache.demand_miss``,
``prefetch.hit_rate``, ``elastic.n_active``, ``dispatch.alg1_cost`` — that
the train driver, the simulator, and every benchmark emit through,
replacing the ad-hoc per-component dicts that used to accumulate in
parallel.

Three instrument kinds:

* :class:`Counter` — monotonically accumulating value (``inc``).
* :class:`Gauge` — last-written value (``set``).
* :class:`Histogram` — streaming count/sum/min/max; with ``keep=True``
  it also retains the raw samples so downstream reductions (e.g. the
  simulator's ``np.mean`` over per-iteration times) can be computed with
  the *exact same* numpy expression as before the refactor — bitwise
  backward compatibility, not just approximate.

The legacy surfaces are thin views: the driver's per-step ``metrics``
list is literally :attr:`MetricsRegistry.steps` (``record_step`` appends
the same-shaped dict it always did while also folding the namespaced
cumulative metrics), and ``SimResult`` fields are reduced from kept
histograms with unchanged expressions.

This is the JAX package's whole registry (``obs/metrics.py``), copied
line for line: the same instruments, the same ``STEP_NAMESPACE``, the
same process-wide current registry, so both packages fold the same
records into the same ``snapshot()``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "use_registry",
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

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, value):
        self.value = value
        return value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


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
        retained samples — p50 is ``quantile(0.5)``, p99
        ``quantile(0.99)``.

        Needs ``keep=True`` (quantiles are not computable from the
        streaming count/sum/min/max alone): a ``keep=False`` histogram
        raises TypeError rather than silently answering from the wrong
        statistics.  An empty histogram returns NaN (same convention as
        :attr:`mean`); a single sample is every quantile of itself.
        """
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

    def snapshot(self) -> dict:
        return {"kind": self.kind, "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean if self.count else None}


# Driver per-step record field -> namespaced cumulative metric folded by
# record_step().  Byte/count fields accumulate into counters; rates and
# level-style fields land in gauges (last value wins).
STEP_NAMESPACE = {
    "cost": ("dispatch.cost_s", "counter"),
    "alg1_est": ("dispatch.alg1_cost", "gauge"),
    "alg1_realized": ("dispatch.alg1_realized", "gauge"),
    "miss_pull": ("cache.miss_pull", "counter"),
    "update_push": ("cache.update_push", "counter"),
    "evict_push": ("cache.evict_push", "counter"),
    "prefetch_bytes": ("prefetch.bytes", "counter"),
    "demand_miss_bytes": ("cache.demand_miss", "counter"),
    "prefetch_hit_rate": ("prefetch.hit_rate", "gauge"),
    "window_dedup_frac": ("prefetch.window_dedup_frac", "gauge"),
    "wire_bytes": ("exchange.wire_bytes", "counter"),
    "payload_bytes": ("exchange.payload_bytes", "counter"),
    "n_reassigned": ("dispatch.n_reassigned", "counter"),
    "n_active": ("elastic.n_active", "gauge"),
    "loss": ("train.loss", "gauge"),
    "wall_s": ("train.wall_s", "counter"),
}


class MetricsRegistry:
    """Namespaced metric store plus the legacy per-step view."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        # Legacy view: the driver's old `metrics` list of per-step dicts.
        self.steps: list[dict] = []

    # -- instrument accessors (create-on-first-use) ------------------------
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

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    # -- per-step driver records -------------------------------------------
    def record_step(self, step: int, fields: dict) -> dict:
        """Append one legacy-shaped per-step record and fold its fields
        into the namespaced cumulative metrics.  Returns the record (the
        same dict the driver used to build inline)."""
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

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """All metrics as plain JSON-able dicts, sorted by name."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def value(self, name: str):
        """Convenience: a metric's scalar value (counter/gauge value,
        histogram mean)."""
        m = self._metrics[name]
        return m.mean if isinstance(m, Histogram) else m.value


# -- process-wide current registry --------------------------------------------
_current = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (a fresh default one at import)."""
    return _current


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``registry`` (None installs a fresh one); returns the
    previous one so callers can restore it."""
    global _current
    prev = _current
    _current = registry if registry is not None else MetricsRegistry()
    return prev


class use_registry:
    """Context manager: install a registry for the duration of a block."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None else MetricsRegistry()

    def __enter__(self) -> MetricsRegistry:
        self._prev = set_registry(self._registry)
        return self._registry

    def __exit__(self, *exc) -> bool:
        set_registry(self._prev)
        return False
