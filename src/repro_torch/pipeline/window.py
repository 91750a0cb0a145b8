"""Sliding lookahead window over the batch stream (BagPipe-style).

BagPipe (Agarwal et al.) observes that a DLRM input pipeline can look a
few batches ahead, and that deduping embedding accesses across that
window — fetch an id once for its *first* use, keep it resident until
its *last* use — removes most of the redundant PS traffic under skewed
(Zipf) streams, where the head ids recur in nearly every batch.

:func:`window_meta` computes exactly that metadata for a list of batches
(per-batch *set* semantics, matching the cache protocol: an id touched
twice inside one batch counts once):

  * ``uids``       — sorted unique valid ids across the window;
  * ``first_use``  — window index of the first batch touching each uid;
  * ``last_use``   — window index of the last batch touching each uid;
  * ``touches``    — number of window batches touching each uid.

``total_touches`` (the sum of per-batch unique counts) is what a
window-blind prefetcher would fetch; ``dedup_saved`` is the fraction of
those fetches the window removes.

:class:`LookaheadWindow` streams the same thing: it wraps any batch
iterator, buffers ``window`` batches ahead, and yields
``(item, meta-over-the-next-window-batches)`` — the metadata a pipelined
trainer has in hand *before* it commits iteration t, which is what lets
a cache shield soon-to-be-reused ids from eviction (see
``repro_torch.core.cache`` ``protect=``) and a dispatcher decide ahead.

The streaming slide is *incremental*: instead of re-deriving the merge
(concat + sort + dedup over all W batches, O(total touches) per step)
the window keeps sorted uid / first-use / last-use / touch planes and
updates only the positions touched by the one leaving and the one
entering batch — O(batch unique + U memmove) per step.  The brute-force
:func:`window_meta` stays as the oracle the incremental path is pinned
against in tests.

Host-side numpy, copied line for line from the JAX package's module of
the same path, so both packages give the same results from one seed.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

__all__ = ["WindowMeta", "window_meta", "LookaheadWindow"]

PAD_ID = -1


@dataclasses.dataclass(frozen=True)
class WindowMeta:
    """Dedup metadata for one window of W batches (see module docstring)."""

    window: int                # number of batches described
    uids: np.ndarray           # (U,) sorted unique valid ids
    first_use: np.ndarray      # (U,) int window index of first touching batch
    last_use: np.ndarray       # (U,) int window index of last touching batch
    touches: np.ndarray        # (U,) int number of touching batches
    total_touches: int         # sum of per-batch unique-id counts

    @property
    def n_unique(self) -> int:
        return int(self.uids.size)

    @property
    def dedup_saved(self) -> int:
        """Fetch ops a window-dedup prefetcher skips vs per-batch fetching."""
        return int(self.total_touches - self.uids.size)

    @property
    def dedup_frac(self) -> float:
        if self.total_touches == 0:
            return 0.0
        return self.dedup_saved / self.total_touches

    def reused_ids(self) -> np.ndarray:
        """Ids touched by more than one window batch — the set worth
        keeping resident across the window."""
        return self.uids[self.touches > 1]


def _batch_unique(b: np.ndarray) -> np.ndarray:
    """Sorted unique valid ids of one batch (PAD = -1 slots dropped)."""
    b = np.asarray(b).reshape(-1)
    return np.unique(b[b != PAD_ID])


def window_meta(batches: Sequence[np.ndarray]) -> WindowMeta:
    """Compute :class:`WindowMeta` for ``batches`` (each any-shape int
    array of ids, PAD = -1 slots ignored)."""
    return _meta_from_unique([_batch_unique(b) for b in batches])


def _meta_from_unique(per_batch: Sequence[np.ndarray]) -> WindowMeta:
    """:class:`WindowMeta` from per-batch sorted-unique id arrays — the
    merge step, so a streaming caller can cache each batch's unique set
    for the W steps it stays buffered instead of recomputing it."""
    total = sum(len(u) for u in per_batch)
    if total == 0:
        z = np.zeros(0, np.int64)
        return WindowMeta(window=len(per_batch), uids=z, first_use=z.copy(),
                          last_use=z.copy(), touches=z.copy(),
                          total_touches=0)
    flat = np.concatenate(per_batch)
    when = np.repeat(np.arange(len(per_batch), dtype=np.int64),
                     [len(u) for u in per_batch])
    uids, inv, touches = np.unique(flat, return_inverse=True,
                                   return_counts=True)
    first = np.full(uids.size, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, inv, when)
    last = np.full(uids.size, -1, np.int64)
    np.maximum.at(last, inv, when)
    return WindowMeta(window=len(per_batch), uids=uids, first_use=first,
                      last_use=last, touches=touches.astype(np.int64),
                      total_touches=int(total))


class LookaheadWindow:
    """Wrap a batch iterator with a W-deep lookahead buffer.

    Yields ``(item, meta)`` where ``meta`` is :func:`window_meta` over the
    *next* ``window`` items (the current item excluded — it is already
    committed; the window is what the pipeline still has time to act on).
    Near the end of the stream the window shrinks; ``window=0`` yields
    empty metadata and buffers nothing beyond the current item.

    ``key`` extracts the id array from a stream item (default: the item
    itself) — e.g. ``key=lambda b: b[0]`` for ``(sparse, dense, labels)``
    tuples.
    """

    def __init__(self, it: Iterator[Any], window: int,
                 key: Optional[Callable[[Any], np.ndarray]] = None):
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self._it = iter(it)
        self.window = window
        self._key = key if key is not None else (lambda item: item)
        self._buf: deque = deque()
        self._exhausted = False
        # incremental merge state, invariant: describes exactly the
        # batches currently in self._buf
        self._abs = 0                       # absolute index of next batch
        self._occ: dict = {}                # id -> deque of absolute indices
        self._uids = np.zeros(0, np.int64)  # sorted ids in the window
        self._first = np.zeros(0, np.int64)  # absolute first-use per uid
        self._last = np.zeros(0, np.int64)   # absolute last-use per uid
        self._touch = np.zeros(0, np.int64)  # touching batches per uid
        self._total = 0                      # sum of per-batch unique counts

    def _add_batch(self, uniq: np.ndarray, a: int):
        """O(|uniq| + U memmove) slide-in of one batch at absolute index a."""
        u = uniq.astype(np.int64, copy=False)
        for i in u.tolist():
            d = self._occ.get(i)
            if d is None:
                self._occ[i] = deque((a,))
            else:
                d.append(a)
        self._total += len(u)
        if not len(u):
            return
        pos = np.searchsorted(self._uids, u)
        exists = np.zeros(len(u), bool)
        inb = pos < len(self._uids)
        exists[inb] = self._uids[pos[inb]] == u[inb]
        ep = pos[exists]
        self._touch[ep] += 1
        self._last[ep] = a
        if not exists.all():
            np_ = pos[~exists]
            nu = u[~exists]
            self._uids = np.insert(self._uids, np_, nu)
            self._first = np.insert(self._first, np_, a)
            self._last = np.insert(self._last, np_, a)
            self._touch = np.insert(self._touch, np_, 1)

    def _remove_batch(self, uniq: np.ndarray):
        """Slide the (oldest) head batch out of the merge state."""
        u = uniq.astype(np.int64, copy=False)
        self._total -= len(u)
        survivors = []
        for i in u.tolist():
            d = self._occ[i]
            d.popleft()
            if d:
                survivors.append((i, d[0]))
            else:
                del self._occ[i]
        if not len(u):
            return
        pos = np.searchsorted(self._uids, u)
        self._touch[pos] -= 1
        dead = self._touch[pos] == 0
        # the head batch is each of its ids' first use, so survivors'
        # first-use advances to their next buffered occurrence
        if survivors:
            sids = np.fromiter((s[0] for s in survivors), np.int64,
                               len(survivors))
            snext = np.fromiter((s[1] for s in survivors), np.int64,
                                len(survivors))
            self._first[np.searchsorted(self._uids, sids)] = snext
        if dead.any():
            dp = pos[dead]
            self._uids = np.delete(self._uids, dp)
            self._first = np.delete(self._first, dp)
            self._last = np.delete(self._last, dp)
            self._touch = np.delete(self._touch, dp)

    def _meta(self) -> WindowMeta:
        """Materialize :class:`WindowMeta` from the incremental planes
        (copies: the planes mutate in place on the next slide)."""
        base = self._buf[0][2] if self._buf else 0
        return WindowMeta(window=len(self._buf), uids=self._uids.copy(),
                          first_use=self._first - base,
                          last_use=self._last - base,
                          touches=self._touch.copy(),
                          total_touches=int(self._total))

    def _fill(self, upto: int):
        while len(self._buf) < upto and not self._exhausted:
            try:
                item = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            # cache the unique set for the W steps the item stays
            # buffered; only the touched positions update per step
            uniq = _batch_unique(self._key(item))
            self._buf.append((item, uniq, self._abs))
            self._add_batch(uniq, self._abs)
            self._abs += 1

    def __iter__(self):
        return self

    def __next__(self):
        self._fill(1)
        if not self._buf:
            raise StopIteration
        item, uniq, _ = self._buf.popleft()
        self._remove_batch(uniq)
        self._fill(self.window)
        return item, self._meta()
