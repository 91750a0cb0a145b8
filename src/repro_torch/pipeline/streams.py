"""The two CUDA streams of the pipelined training step.

JAX queues every jitted stage and returns, so the JAX package's runner
gets its overlap from issue order alone.  Here three things would
serialise a step on one stream: the decide stage waits for the device
before its host-side greedy (``tolist``), a host-to-device batch upload
waits for its stream, and a read of the loss waits for the train stage.
So at depth >= 2 on a card the decide/advance chain (decide, realized,
repair, advance, the prefetch selection, the batch uploads) runs on a
stream of its own, and training on the caller's stream; a host wait on
the chain then never waits for a queued train, and the reverse.

:class:`ChainStreams` holds the two streams and the rules that order
them:

  * ``chain()`` is the context the chain's stages run in, ``trainer()``
    that of the train stream;
  * ``mark()`` records an event on the current stream and
    ``wait(event)`` makes the current stream wait for it: train(t) waits
    for the event recorded after advance(t), the prefetch pull (on the
    train stream) for the chain's selection, and the chain for the pull;
  * ``give(tensors)``: a tensor the chain made and the train stream
    reads is recorded on the train stream, so the caching allocator
    does not hand its memory out again before the train stream is done;
    ``take(tensors)`` the same the other way (a cache state restored
    from a checkpoint on the caller's stream);
  * ``to_host(x)`` copies a device scalar or small tensor into pinned
    host memory without waiting; the host reads it after the event of
    its stream (:class:`HostValue` for the loss).

Disabled (depth 1, or the CPU) every method is a no-op and ``to_host``
returns its input: one stream, the synchronous path.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch

__all__ = ["ChainStreams", "HostValue"]


class HostValue:
    """A host copy of a device value, readable once ``event`` completed:
    ``float()`` and ``int()`` wait for the event, not for the stream."""

    __slots__ = ("value", "event")

    def __init__(self, value: torch.Tensor,
                 event: Optional[torch.cuda.Event]):
        self.value, self.event = value, event

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.value

    def __float__(self) -> float:
        return float(self.get())

    def __int__(self) -> int:
        return int(self.get())


class ChainStreams:
    def __init__(self, device: torch.device, enabled: bool):
        self.enabled = enabled and device.type == "cuda"
        self.train = self.chain_stream = None
        if self.enabled:
            self.train = torch.cuda.current_stream(device)
            self.chain_stream = torch.cuda.Stream(device)
            # what the caller made before the run is ready for the chain
            self.chain_stream.wait_stream(self.train)

    def chain(self):
        """The context the chain's stages run in."""
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.chain_stream)

    def trainer(self):
        """The context of the train stream (for work the chain issues
        there, such as the prefetch pull)."""
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.train)

    def mark(self, timing: bool = False) -> Optional[torch.cuda.Event]:
        """An event recorded on the current stream; ``timing`` makes it
        one ``elapsed_time`` can read."""
        if not self.enabled:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(torch.cuda.current_stream())
        return ev

    def wait(self, event: Optional[torch.cuda.Event]):
        """The current stream waits for ``event``."""
        if self.enabled and event is not None:
            torch.cuda.current_stream().wait_event(event)

    def give(self, tensors: Iterable[torch.Tensor]):
        """Record tensors the chain made as used by the train stream."""
        if self.enabled:
            for t in tensors:
                t.record_stream(self.train)

    def take(self, tensors: Iterable[torch.Tensor]):
        """Record tensors the caller's stream made (a restored cache
        state) as used by the chain."""
        if self.enabled:
            for t in tensors:
                t.record_stream(self.chain_stream)

    def to_host(self, x):
        """A pinned host copy of ``x``, filled on the current stream
        without waiting (the input itself when disabled)."""
        if not self.enabled or not isinstance(x, torch.Tensor):
            return x
        return x.to("cpu", non_blocking=True)

    def host_value(self, x: torch.Tensor):
        """``x`` as a :class:`HostValue` read after the current stream's
        work so far (the input itself when disabled)."""
        if not self.enabled:
            return x
        return HostValue(self.to_host(x), self.mark())

    def finish(self):
        """The caller's stream waits for the chain: its outputs are ready
        for whatever runs after the run."""
        if self.enabled:
            self.train.wait_stream(self.chain_stream)
