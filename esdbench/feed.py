"""A cell's stream, drawn outside the process that issues kernels.

A producer process replays the generator batch by batch
(:meth:`gen.CTRStream.draw`, no lookup) and hands the generator's state
at the start of batch t to mapper t mod M.  The mapper draws that batch
again from the state and turns its numbers into arrays
(:meth:`gen.CTRStream.assemble`).  The consumer takes batch t from
mapper t mod M, so the batches come in order and byte for byte as
``CTRStream(cfg, mix).batches(seed_words(seed), k)`` draws them in one
thread.

Work moves only on request: the consumer keeps ``_AHEAD`` requests out
with each mapper, a mapper asks the producer for a state for each, so no
process runs further ahead.  The processes start with ``spawn``, import
numpy and this package's generator only, talk over pipes, and end when
the pipe to the process they serve closes: on :meth:`Feed.close`, or when
that process dies.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
import traceback

import numpy as np

from .gen import CTRStream, seed_words

__all__ = ["Feed", "first_batches", "mapper_count", "stop_helpers"]

_AHEAD = 2          # batches a mapper may hold ready or in hand
_POLL_S = 0.1       # between looks at ``stop`` and at the processes
_CLOSE_S = 30.0     # for the processes to end once their pipes close


def mapper_count(cores: int | None = None) -> int:
    """Mappers for a host of ``cores``: two cores stay with the process
    that issues kernels and the producer, then a mapper for every two,
    1 to 4."""
    if cores is None:
        cores = len(os.sched_getaffinity(0))
    return max(1, min(4, (cores - 2) // 2))


def _produce(cfg, mix, seed, batches, conns):
    k = mix["workers"] * mix["batch_per_worker"]
    t = 0
    try:
        gen = CTRStream(cfg, mix)
        rng = np.random.default_rng(seed_words(seed))
        while batches is None or t < batches:
            conn = conns[t % len(conns)]
            conn.recv()
            conn.send(rng.bit_generator.state)
            gen.draw(rng, k)
            t += 1
    except (EOFError, BrokenPipeError):
        return                        # a mapper has gone: the feed ends
    except BaseException:
        # the error takes batch t's place; its mapper hands it on
        conns[t % len(conns)].send(traceback.format_exc())


def _map(cfg, mix, consumer, producer):
    k = mix["workers"] * mix["batch_per_worker"]
    try:
        gen = CTRStream(cfg, mix)
        rng = np.random.Generator(np.random.PCG64())
        while True:
            consumer.recv()
            producer.send(None)
            state = producer.recv()
            if isinstance(state, str):
                consumer.send(state)
                return
            rng.bit_generator.state = state
            consumer.send(gen.assemble(gen.draw(rng, k)))
    except (EOFError, BrokenPipeError):
        return
    except BaseException:
        consumer.send(traceback.format_exc())


class Feed:
    """The batches of ``(cfg, mix)`` from ``seed`` (``batches`` of them,
    or without end), drawn by a producer and ``mappers`` processes.
    Iterating stops once ``stop`` is set; :meth:`close` (or leaving the
    ``with`` block) ends every process and waits for it."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 batches: int | None = None, mappers: int | None = None):
        CTRStream(cfg, mix)          # a malformed record raises here
        ctx = mp.get_context("spawn")
        n = mapper_count() if mappers is None else mappers
        self.stop = threading.Event()
        self._batches, self._t = batches, 0
        self._conns, self._procs = [], []
        up = [ctx.Pipe() for _ in range(n)]      # mapper i <-> producer
        down = [ctx.Pipe() for _ in range(n)]    # consumer <-> mapper i
        procs = [ctx.Process(target=_produce, name="feed-producer",
                             args=(cfg, mix, seed, batches,
                                   [b for _, b in up]))]
        procs += [ctx.Process(target=_map, name=f"feed-mapper-{i}",
                              args=(cfg, mix, down[i][1], up[i][0]))
                  for i in range(n)]
        self._conns = [a for a, _ in down]
        try:
            for p in procs:
                p.start()
                self._procs.append(p)
        except BaseException:
            self.close()
            raise
        finally:
            # the processes hold the other ends now: a pipe then closes
            # when the process at its far end ends
            for a, b in up:
                a.close()
                b.close()
            for _, b in down:
                b.close()
        # batch t is asked of mapper t mod n: the first _AHEAD rounds now
        for t in range(_AHEAD * n):
            if self._wanted(t):
                self._conns[t % n].send(None)

    def _wanted(self, t: int) -> bool:
        return self._batches is None or t < self._batches

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        t = self._t
        if self._batches is not None and t >= self._batches:
            raise StopIteration
        conn = self._conns[t % len(self._conns)]
        while not conn.poll(_POLL_S):
            if self.stop.is_set():
                raise StopIteration
            ended = [p for p in self._procs if p.exitcode]
            if ended:
                raise RuntimeError(f"{ended[0].name} ended with code "
                                   f"{ended[0].exitcode}")
        if self.stop.is_set():
            raise StopIteration
        try:
            item = conn.recv()
        except EOFError:
            raise RuntimeError("a feed process ended early") from None
        if isinstance(item, str):
            raise RuntimeError(f"the feed failed:\n{item}")
        self._t += 1
        if self._wanted(t + _AHEAD * len(self._conns)):
            conn.send(None)
        return item

    def close(self):
        """Stop, close the pipes and wait for every process; one that
        outlives ``_CLOSE_S`` is terminated."""
        self.stop.set()
        for conn in self._conns:
            conn.close()
        deadline = time.monotonic() + _CLOSE_S
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def first_batches(cfg: dict, mix: dict, seed: int, steps: int) -> list:
    """The first ``steps`` batches of the cell's stream for ``seed``."""
    with Feed(cfg, mix, seed, batches=steps) as feed:
        return list(feed)


def stop_helpers():
    """Wait for the helper process that ``spawn`` starts beside its
    children (multiprocessing's resource tracker), once every feed of
    this process is closed, so that none is left behind the run."""
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()
