"""Host <-> device copies of the pipeline's ticks: pinned, fenced by CUDA
events, never a stream synchronisation.

The JAX package has no counterpart: there asynchronous dispatch and
``np.asarray`` do this work. The port computes on the caller's current
CUDA stream and keeps the copies off it:

- :class:`Copies` holds the two side streams of one device, ``upload``
  for the frames and ``download`` for the task extras, and the span
  recorder its rings time their waits and fills with (``spans``, the
  pipeline's: ``ssyt.ring.wait``, ``ssyt.ring.fill``).
- :class:`FrameRing`: ``RING_DEPTH`` pinned host slots and device slots
  of one frame-batch shape, allocated once. :meth:`FrameRing.slot` fills
  the next host slot (PyTorch's CPU copy, spread over its intra-op
  threads: one thread's ``np.copyto`` of a (8, 1080, 1920, 3) batch
  takes longer than the whole copy to the card), copies it to its
  device slot on the upload stream and makes the current stream wait
  for that copy. A host slot is refilled only after its copy has run; a
  device slot is copied into only after the current stream has passed
  the end of the ``with`` block of its previous use, so the reads of
  the frames go inside that block.
- :func:`to_device`: a small host array through a pinned buffer of the
  caching host allocator, copied on the current stream without blocking
  the host (the allocator keeps the buffer until the copy has run).
- :class:`Download`: a device tensor copied into a pinned host buffer on
  the current stream, with an event recorded after the copy; ``wait``
  blocks on that event alone.

A non-blocking copy between the card and pageable memory is synchronous,
so every host buffer here is pinned; pinning that fails raises. On the
CPU (``device="cpu"``) nothing is pinned and nothing waits: the tensors
are the host's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from strongsort_yolo_tpu_torch.utils.profiling import StageTimers

RING_DEPTH = 2  # frame batches in flight: one being copied, one computed


class Copies:
    """The upload and download streams of one device (None on the CPU),
    the frame rings made on first use of a shape, and ``spans``, the
    recorder of the rings' spans (a new one where none is given)."""

    def __init__(self, device: torch.device, spans: StageTimers | None = None):
        self.device = device
        self.spans = StageTimers() if spans is None else spans
        self.cuda = device.type == "cuda"
        self.upload = torch.cuda.Stream(device) if self.cuda else None
        self.download = torch.cuda.Stream(device) if self.cuda else None
        self._rings: dict[tuple[int, ...], FrameRing] = {}

    def ring(self, shape) -> FrameRing | None:
        """A new ring of (B, H, W, 3) slots (None on the CPU)."""
        return FrameRing(tuple(shape), self) if self.cuda else None

    @contextlib.contextmanager
    def frames(self, frames: np.ndarray, ring: FrameRing | None = None):
        """(B, H, W, 3) uint8 host frames -> the device tensor to read
        them from inside the block; on the card a slot of ``ring``, or of
        this object's ring of their shape."""
        frames = np.ascontiguousarray(frames)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"frames must be (B, H, W, 3) uint8 BGR, got {frames.shape} "
                f"{frames.dtype}"
            )
        if not self.cuda:
            yield torch.from_numpy(frames)
            return
        if ring is None:
            ring = self._rings.get(frames.shape)
            if ring is None:
                ring = self._rings[frames.shape] = self.ring(frames.shape)
        with ring.slot(frames) as dev:
            yield dev


class FrameRing:
    """Pinned host slots and device slots of one (B, H, W, 3) uint8 shape,
    reused in turn. ``fill_ms`` is the host's time of the last fill of a
    slot; ``stalls`` counts the slots whose previous copy had not
    finished when they came round again (the host then waited for it)."""

    def __init__(self, shape: tuple[int, ...], copies: Copies):
        self.shape = shape
        self._copies = copies
        dev = copies.device
        self._host = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                      for _ in range(RING_DEPTH)]
        self._dev = [torch.empty(shape, dtype=torch.uint8, device=dev)
                     for _ in range(RING_DEPTH)]
        for d in self._dev:  # freed only after the upload stream's copies
            d.record_stream(copies.upload)
        self._copied = [torch.cuda.Event() for _ in range(RING_DEPTH)]
        self._consumed = [torch.cuda.Event() for _ in range(RING_DEPTH)]
        self._next = 0
        self.fill_ms = 0.0
        self.stalls = 0

    @contextlib.contextmanager
    def slot(self, frames: np.ndarray):
        if frames.shape != self.shape:
            raise ValueError(f"frames {frames.shape} do not fit a ring of "
                             f"{self.shape}")
        i, self._next = self._next, (self._next + 1) % RING_DEPTH
        copied, consumed = self._copied[i], self._consumed[i]
        if not copied.query():
            self.stalls += 1
        spans = self._copies.spans
        with spans.stage("ssyt.ring.wait"):
            copied.synchronize()  # the host slot's previous copy has run
        with spans.stage("ssyt.ring.fill"):
            t0 = time.perf_counter()
            self._host[i].copy_(torch.from_numpy(frames))
            self.fill_ms = (time.perf_counter() - t0) * 1e3
        upload = self._copies.upload
        upload.wait_event(consumed)  # the device slot's last reader is done
        with torch.cuda.stream(upload):
            self._dev[i].copy_(self._host[i], non_blocking=True)
            copied.record(upload)
        compute = torch.cuda.current_stream(self._copies.device)
        compute.wait_event(copied)
        try:
            yield self._dev[i]
        finally:
            consumed.record(compute)


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. On the card through a pinned buffer,
    copied on the current stream without blocking the host; on the CPU
    the array's own memory."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return src
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


class Download:
    """``tensor`` on its way to the host: on the card a non-blocking copy
    into pinned memory on the current stream and ``done``, the event
    recorded after it; on the CPU the tensor itself (``done`` None)."""

    def __init__(self, tensor: torch.Tensor):
        self.done = None
        if tensor.device.type != "cuda":
            self._host = tensor
            return
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                 pin_memory=True)
        self._host.copy_(tensor, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def query(self) -> bool:
        """Whether the copy has landed (never blocks)."""
        return self.done is None or self.done.query()

    def wait(self) -> np.ndarray:
        """Block on this copy's event only -> the host array."""
        if self.done is not None:
            self.done.synchronize()
        return self._host.numpy()
