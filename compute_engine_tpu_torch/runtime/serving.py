"""Continuous-batching serving engine.

The port of ``compute_engine_tpu.runtime.serving``: a request queue that
coalesces single images into batches of one fixed shape, pads short batches
with zeros, runs one forward per batch and fans the rows back out to
per-request futures. LCE itself is a synchronous library call with no serving
stack; this is the single-device building block of one.

The batcher is a second thread. PyTorch's current device and current stream
are per thread: the port's kernels launch on the current stream of their
input's device, so they follow the batcher. Over an ``Interpreter`` on the
card the batcher stages each batch straight into the compiled forward's
static input, captures the forward's graph at the first batch and replays
it at every batch, all on its own current stream, where its events mark the
copies and the forward. The kernels' launch counts are plain attributes, to
be read after ``close()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["ServingEngine", "ServingStats"]


@dataclasses.dataclass
class ServingStats:
    """Counts, and where the batches' time went (sums over batches, ms).

    ``stack_ms`` is host time copying the requests' images into the batch
    buffer. Serving a CUDA device, ``h2d_ms``, ``forward_ms`` and ``d2h_ms``
    are spans between CUDA events on the batcher's stream (the copy to the
    card, ``infer_fn``, the copy of the whole result back); otherwise
    ``forward_ms`` is host time in ``infer_fn`` and the other two stay 0.
    ``queue_wait_ms`` is host time from each request's ``submit`` to the
    batcher taking it off the queue. ``batches_full`` counts the batches
    that closed at ``batch_size`` requests; the rest, ``batches_timed_out``,
    closed short of it when ``max_delay_ms`` ran out. A failed batch counts
    in none of these. Together they tell an operator whether to change
    ``batch_size`` or ``max_delay_ms``: a long wait beside full batches
    asks for a larger batch, timed-out batches for a shorter delay.
    """

    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    stack_ms: float = 0.0
    h2d_ms: float = 0.0
    forward_ms: float = 0.0
    d2h_ms: float = 0.0
    queue_wait_ms: float = 0.0
    batches_full: int = 0

    @property
    def batches_timed_out(self):
        return self.batches - self.batches_full

    @property
    def mean_batch_fill(self):
        total = self.requests + self.padded_slots
        return self.requests / total if total else 0.0


def _target_of(infer_fn):
    """The object that takes its batch on a device, when ``infer_fn`` says
    so (an ``Interpreter`` or its bound ``__call__``), and that device.
    ``(None, None)`` for any other callable (``Interpreter.predict`` among
    them, which takes arrays)."""
    if getattr(infer_fn, "__name__", None) == "__call__":
        infer_fn = getattr(infer_fn, "__self__", None)
    device = getattr(infer_fn, "device", None)
    if not isinstance(device, torch.device):
        return None, None
    return infer_fn, device


class ServingEngine:
    """Coalesces single-image requests into batched device calls.

    Args:
      infer_fn: callable (B, H, W, 3) -> (B, num_classes); typically an
        ``Interpreter``. Given an ``Interpreter`` (anything with a ``device``)
        the engine stacks each batch into one reusable host buffer, pinned
        when the device is a card, copies it to the device itself and passes
        a tensor there: into the compiled forward's static input when the
        target has an ``input_buffer`` for it, so that the forward copies
        nothing more; any other callable gets the host buffer as a numpy
        array. The result may be a tensor on the card: the whole batch comes
        back with one ``.cpu()``, one synchronisation per batch. A batch is
        never run anywhere but where ``infer_fn`` runs it.
      batch_size: the one batch shape; short batches are padded with zeros.
      max_delay_ms: how long the batcher waits, after a batch's first
        request, for the batch to fill.
      input_dtype: the requests' dtype; ``None`` locks to the first
        request's.
    """

    def __init__(self, infer_fn, batch_size=32, max_delay_ms=5.0,
                 input_dtype=None):
        self.infer_fn = infer_fn
        self.batch_size = batch_size
        self.max_delay = max_delay_ms / 1e3
        self.stats = ServingStats()
        self._target, self._device = _target_of(infer_fn)
        self._cuda = self._device is not None and self._device.type == "cuda"
        # One engine-wide input dtype: every batch goes through one buffer
        # and one forward signature, so requests must be homogeneous.
        # Mismatches are refused at submit() rather than promoted in the
        # buffer (int8 + float32 -> float32 would feed an int8-input
        # interpreter's dequantisation a dtype it was not configured for).
        self._input_dtype = (np.dtype(input_dtype)
                             if input_dtype is not None else None)
        self._dtype_lock = threading.Lock()
        self._host = None  # (batch_size, H, W, 3) host tensor, made once
        self._host_np = None  # its numpy view
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image) -> Future:
        """Enqueue one (H, W, 3) image; resolves to its row of the output
        (numpy).

        The image's dtype is kept: int8/uint8 requests reach an
        ``Interpreter(input_scale=...)`` unwidened, a quarter of float32's
        bytes from host to device. Every request must have the engine's input
        dtype (given, or locked to the first request's); another raises
        ``TypeError``."""
        if self._stop.is_set():
            raise RuntimeError("the serving engine is closed")
        fut: Future = Future()
        img = np.asarray(image)
        if img.dtype not in (np.dtype(np.int8), np.dtype(np.uint8)):
            img = img.astype(np.float32, copy=False)
        with self._dtype_lock:
            if self._input_dtype is None:
                self._input_dtype = img.dtype
            elif img.dtype != self._input_dtype:
                raise TypeError(
                    f"request dtype {img.dtype} does not match the engine's "
                    f"input dtype {self._input_dtype}; one buffer and one "
                    "forward serve every batch, so requests must be "
                    "homogeneous")
        self._queue.put((img, fut, time.perf_counter()))
        return fut

    def predict(self, image, timeout=None):
        return self.submit(image).result(timeout=timeout)

    def close(self):
        """Stop the batcher; requests not yet batched fail with
        ``RuntimeError``."""
        self._stop.set()
        self._thread.join(timeout=5)
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("the serving engine was closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _collect(self):
        """Block for the first request, then fill the batch up to max_delay.
        Returns the batch's ``(image, future)`` items and the ms its
        requests waited in the queue, summed."""
        try:
            img, fut, submitted = self._queue.get(timeout=0.1)
        except queue.Empty:
            return [], 0.0
        waited = time.perf_counter() - submitted
        items = [(img, fut)]
        deadline = time.monotonic() + self.max_delay
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                img, fut, submitted = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            waited += time.perf_counter() - submitted
            items.append((img, fut))
        return items, waited * 1e3

    def _mark(self):
        """A point in time: a CUDA event on the batcher's stream when serving
        a card, else the host clock."""
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def _span_ms(self, a, b):
        return a.elapsed_time(b) if self._cuda else (b - a) * 1e3

    def _stage(self, items):
        """The batch of ``items``, zero-padded, where ``infer_fn`` takes it;
        the host time of stacking it (ms) and the marks around the copy to
        the device."""
        t0 = time.perf_counter()
        if self._host is None:
            shape = (self.batch_size, *items[0][0].shape)
            self._host = torch.from_numpy(np.zeros(shape, self._input_dtype))
            if self._cuda:
                self._host = self._host.pin_memory()
            self._host_np = self._host.numpy()
        for i, (img, _) in enumerate(items):
            if img.shape != self._host_np.shape[1:]:
                raise ValueError(
                    f"request shape {img.shape} does not match the engine's "
                    f"image shape {self._host_np.shape[1:]}")
            self._host_np[i] = img
        self._host_np[len(items):] = 0
        stack_ms = (time.perf_counter() - t0) * 1e3
        start = self._mark()
        if self._device is None:
            batch = self._host_np
        elif self._cuda and hasattr(self._target, "input_buffer"):
            batch = self._target.input_buffer(self._host.shape,
                                              self._host.dtype)
            batch.copy_(self._host, non_blocking=True)
        else:
            batch = self._host.to(self._device, non_blocking=True)
        return batch, stack_ms, start, self._mark()

    def _forward(self, batch):
        """``infer_fn`` on the batch; the result on the host as numpy, and
        the marks after the forward and after the copy back."""
        out = self.infer_fn(batch)
        done = self._mark()
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()  # the batch's one synchronisation
        else:
            out = np.asarray(out)
        if np.may_share_memory(out, self._host_np):
            out = out.copy()  # the buffer is written again by the next batch
        return out, done, self._mark()

    def _serve(self, items, queue_wait_ms=0.0):
        """Serves ``(image, future)`` items as one batch; their requests
        waited ``queue_wait_ms`` in the queue."""
        try:
            # The batcher is its own thread: make the served card its current
            # device, for the events and for whatever infer_fn allocates.
            with (torch.cuda.device(self._device) if self._cuda
                  else contextlib.nullcontext()):
                with span("serving/stack+h2d"):
                    batch, stack_ms, t_start, t_on_device = self._stage(items)
                with span("serving/forward"):
                    out, t_done, t_back = self._forward(batch)
                if self._cuda:
                    t_back.synchronize()
        except Exception as e:  # to every waiter of this batch; carry on
            for _, fut in items:
                fut.set_exception(e)
            return
        stats = self.stats  # a failed batch counts nowhere
        stats.stack_ms += stack_ms
        if self._cuda:
            stats.h2d_ms += self._span_ms(t_start, t_on_device)
            stats.d2h_ms += self._span_ms(t_done, t_back)
        stats.forward_ms += self._span_ms(t_on_device, t_done)
        stats.requests += len(items)
        stats.batches += 1
        stats.padded_slots += self.batch_size - len(items)
        stats.queue_wait_ms += queue_wait_ms
        stats.batches_full += len(items) == self.batch_size
        for i, (_, fut) in enumerate(items):
            fut.set_result(out[i])

    def _loop(self):
        while not self._stop.is_set():
            items, waited_ms = self._collect()
            if items:
                self._serve(items, waited_ms)
