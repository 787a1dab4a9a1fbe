"""Double-buffered asynchronous host readback for render loops.

Counterpart of ``particlesystem_tpu/runtime/readback.py`` (BASELINE config
5: a render loop whose sim never syncs with the display).  The sim thread
publishes device tensors; each is copied into one of ``depth`` pinned host
buffers on a side stream, with a CUDA event recorded behind the copy, while
the sim's own stream goes on to the next frame.  The copy of frame ``k`` is
pushed into the native lock-free single-producer single-consumer ring
(``native/psnative.cpp``) when frame ``k + 1`` is published, so the
device-to-host transfer overlaps the next frame's compute.  A render or IO
consumer drains the ring at its own pace; when it is behind, frames are
dropped rather than ever stalling the device queue.  A Python deque stands
in where the native library cannot be built.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch

from ..utils.native import get_lib


class FrameRing:
    """SPSC frame ring over the native library (``native=False`` or a
    machine without a compiler: a Python deque)."""

    def __init__(self, frame_bytes: int, depth: int = 3,
                 native: bool = True):
        self.frame_bytes = int(frame_bytes)
        self.depth = int(depth)
        self._lib = get_lib() if native else None
        if self._lib is not None:
            self._ring = self._lib.ps_ring_create(self.frame_bytes, self.depth)
            self._deque = None
        else:
            self._ring = None
            self._deque = collections.deque(maxlen=depth)

    def push(self, frame: np.ndarray) -> bool:
        """Publish one frame (host array).  False = ring full, frame dropped."""
        buf = np.ascontiguousarray(frame)
        if buf.nbytes > self.frame_bytes:
            raise ValueError(f"frame {buf.nbytes}B > ring {self.frame_bytes}B")
        if self._lib is not None:
            return bool(self._lib.ps_ring_try_push(
                self._ring, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes))
        if len(self._deque) >= self.depth:
            return False
        self._deque.append(buf.copy())
        return True

    def pop(self, shape, dtype=np.float32) -> Optional[np.ndarray]:
        """Consume one frame; None when empty."""
        out = np.empty(shape, dtype)
        if self._lib is not None:
            ok = self._lib.ps_ring_try_pop(
                self._ring, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
            return out if ok else None
        if not self._deque:
            return None
        src = self._deque.popleft()
        out[...] = src.view(dtype).reshape(shape)
        return out

    def fill(self) -> int:
        if self._lib is not None:
            return int(self._lib.ps_ring_fill(self._ring))
        return len(self._deque)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._ring:
            self._lib.ps_ring_destroy(self._ring)
            self._ring = None


class AsyncReadback:
    """Double-buffered device-to-host publisher.

    ``publish(tensor)`` starts the copy of this frame and pushes the
    previous frame, whose copy has had a whole frame's time to finish, to
    the ring; a full ring drops the frame.  Nothing is ever queued on the
    sim's stream but one event, so the sim never waits for the ring or the
    consumer.  ``flush()`` pushes the last frame.  A CPU tensor is copied
    at once."""

    def __init__(self, frame_bytes: int, depth: int = 3,
                 native: bool = True):
        self.ring = FrameRing(frame_bytes, depth, native=native)
        self._pending = None     # (host array view, event or None)
        self._buffers = None     # pinned host buffers (CUDA only)
        self._stream = None
        self._next = 0
        self.published = 0
        self.dropped = 0

    def publish(self, tensor: torch.Tensor) -> None:
        prev, self._pending = self._pending, self._start_copy(tensor)
        if prev is not None:
            self._emit(prev)

    def flush(self) -> None:
        if self._pending is not None:
            self._emit(self._pending)
            self._pending = None

    def _start_copy(self, tensor: torch.Tensor):
        tensor = tensor.detach()
        nbytes = tensor.numel() * tensor.element_size()
        if nbytes > self.ring.frame_bytes:
            raise ValueError(f"frame {nbytes}B > ring "
                             f"{self.ring.frame_bytes}B")
        if tensor.device.type != "cuda":
            return tensor.contiguous().numpy().copy(), None
        dev = tensor.device
        if self._buffers is None:
            # `depth` of them, and never fewer than the two a pending frame
            # and a starting copy need
            self._buffers = [torch.empty(self.ring.frame_bytes,
                                         dtype=torch.uint8, pin_memory=True)
                             for _ in range(max(2, self.ring.depth))]
            self._stream = torch.cuda.Stream(dev)
        buf = self._buffers[self._next][:nbytes].view(tensor.dtype).view(
            tensor.shape)
        self._next = (self._next + 1) % len(self._buffers)
        src = tensor.contiguous()
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            buf.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        src.record_stream(self._stream)  # keep src's memory until the copy ran
        return buf.numpy(), event

    def _emit(self, pending) -> None:
        host, event = pending
        if event is not None:
            event.synchronize()  # the copy only; the sim's stream runs on
        if self.ring.push(host):
            self.published += 1
        else:
            self.dropped += 1
