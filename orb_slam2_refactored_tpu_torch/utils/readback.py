"""Asynchronous device-to-host reads, without threads.

The JAX package starts a read with `copy_to_host_async` and hands the
blocking `np.asarray` to a thread pool (its tracker's and `LocalMapper`'s
fetch pools); the future's `done()` tells its pipelined mode whether a
stage's read has landed. Here CUDA does that job: `Readback(t)` on a CUDA
tensor copies it with `non_blocking=True` into a pinned host buffer on the
current stream of the tensor's device and records a `torch.cuda.Event`
after the copy on that stream. `done()` is the event's query and
`result()` waits for the event, then returns the buffer as a numpy array.
Every read gets a buffer of its own from PyTorch's caching host allocator,
which does not hand a block out again before the copy's event has
completed, so k reads in flight never share one.

On a CPU tensor the read is resolved at once: the result is a copy taken
when the read is made, as the card's copy is, and `done()` is always
true, so the pipelined mode's schedule on the CPU is deterministic.
"""

from __future__ import annotations

import numpy as np
import torch


class Readback:
    """A device-to-host read in flight: `done()`, `result()`."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            # the copy runs on the current stream of the tensor's device,
            # which need not be the calling thread's current device
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.clone()
            self._event = None

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

