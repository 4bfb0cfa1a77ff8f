"""Host-to-device uploads of packed frames from a worker pool.

The JAX tracker packs and uploads frames on a pool of
`TPU_SLAM_UPLOAD_THREADS` workers (`prefetch_rgbd`, default 4), each
future resolving to the device buffer. Here a worker, on the card:
- packs straight into a pinned buffer from PyTorch's caching host
  allocator (the caller's `fill` writes the packed bytes into its numpy
  view);
- copies it with `non_blocking=True` on the pool's upload stream of the
  tracker's device (the copy overlaps the tracker's work on its own
  stream) into a buffer allocated on that stream;
- records a `torch.cuda.Event` after the copy, which the tensor carries as
  `upload_event`.
The worker makes the tracker's device current first: a thread's current
device is cuda:0 whatever the tracker's. The pinned buffer may be dropped
at once: the caching host allocator records the copy's stream and hands
the block out again only after the copy has completed.

The consumer calls `ready(t)` before its first use of `t`: its current
stream waits for the copy's event, and `t.record_stream` marks the buffer
as used there, so the allocator does not give the block to another upload
while the consumer's kernels still read it.

On the CPU the futures resolve to CPU tensors of the packed bytes.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Tuple

import numpy as np
import torch


class UploadPool:
    """`submit(shape, fill)` -> a Future of a uint8 tensor of `shape` on
    `device`, filled on the host by `fill(numpy_view)`."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pool = ThreadPoolExecutor(
            int(os.environ.get("TPU_SLAM_UPLOAD_THREADS", "4")),
            "frame-upload")
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def submit(self, shape: Tuple[int, ...],
               fill: Callable[[np.ndarray], object]) -> Future:
        return self._pool.submit(self._upload, tuple(shape), fill)

    def _upload(self, shape, fill) -> torch.Tensor:
        if self._stream is None:
            host = np.empty(shape, np.uint8)
            fill(host)
            return torch.from_numpy(host)
        with torch.cuda.device(self.device):
            host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            fill(host.numpy())
            with torch.cuda.stream(self._stream):
                out = torch.empty(shape, dtype=torch.uint8,
                                  device=self.device)
                out.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        out.upload_event = event
        return out


def ready(t: torch.Tensor) -> torch.Tensor:
    """`t` usable on the current stream of its device: waits there for
    its upload's event, if it (or the tensor it is a view of) came from an
    `UploadPool`, and records the stream on it."""
    event = getattr(t, "upload_event", None)
    if event is None and t._base is not None:
        event = getattr(t._base, "upload_event", None)
    if event is not None:
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(event)
        t.record_stream(stream)
    return t
