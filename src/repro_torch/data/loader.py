"""Prefetching data loader: keeps the next batches ready on a worker
thread while the current step runs, and composes a dispatch callback
into that overlap.

The port's copy of the JAX package's ``PrefetchLoader`` and
``DispatchingLoader``; each upstream pull is a ``data.load`` span on the
``loader`` track of the port's tracer (:mod:`repro_torch.obs.trace`),
and each consumer's wait for a batch a ``data.wait`` span on the
consumer's thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

from ..obs.trace import get_tracer

__all__ = ["PrefetchLoader", "DispatchingLoader"]

_SENTINEL = object()


class PrefetchLoader:
    """Wraps an iterator; keeps ``depth`` batches ready on a worker thread."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # Each upstream pull is spanned on the "loader" track: these
        # spans come from the worker thread, so in an exported trace
        # they genuinely overlap the main thread's stages.
        try:
            it = iter(self._it)
            while True:
                with get_tracer().span("data.load", track="loader"):
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                self._q.put(item)
        except BaseException as e:  # pragma: no cover
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_done", False):
            raise StopIteration
        with get_tracer().span("data.wait"):
            item = self._q.get()
        if item is _SENTINEL:
            self._done = True          # re-raisable: queue is empty now
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class DispatchingLoader:
    """Prefetch + one-step lookahead dispatch.

    ``dispatch_fn(next_batch) -> dispatched_batch`` runs while the caller
    is still training on the current batch — the paper's decision-hiding
    pipeline.  Yields already-dispatched batches.
    """

    def __init__(self, it: Iterator[Any], dispatch_fn: Callable[[Any], Any],
                 depth: int = 2):
        self._inner = PrefetchLoader(it, depth)
        self._fn = dispatch_fn
        self._pending = None
        self._primed = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self._primed:
            self._pending = self._fn(next(self._inner))
            self._primed = True
        out = self._pending
        if out is None:
            raise StopIteration
        try:
            self._pending = self._fn(next(self._inner))
        except StopIteration:
            self._pending = None
        return out
