"""The compiled forward: one captured CUDA graph per input shape and dtype.

The port's counterpart of ``jax.jit`` as the JAX runtime uses it: JAX's
``Interpreter`` jits its forward once per batch shape, with the weights as
jit arguments. Here the first call at an input (shape, dtype) runs the
forward eagerly a few times on a side stream (``warm_up``: the kernels are
built or loaded, cuDNN and cuBLAS initialise, the kernels' shared-memory
attributes are set), then captures one whole forward into a
``torch.cuda.CUDAGraph`` (``capture``). Every call copies its input into the
graph's static input and replays the graph: one launch for the host where
the eager forward has 60-100.

The weights are read where they lie, by address, as jit arguments are: a
``copy_`` into a weight changes what the next replay computes (replacing
the tensor in a layer dict does not). Each call returns a fresh tensor, a
clone of the graph's output, as jit returns a fresh array.

Launch counts (``kernels.counts``): the capture's launches are recorded
into a ledger, not counted, and every replay adds the ledger. The warm-up
forwards are the compile step and are not counted either, so the counts
hold the forwards the caller asked for.

What a graph cannot hold: the kernels' debug builds wait for each launch
to read their error word, so a call inside ``kernels.debug_checks()``
raises (debug checks stay an eager ``packed_apply`` tool); profiler spans
inside the forward (``utils.profiling.annotate``) are recorded once, at the
capture, so profile by kernel name through ``packed_apply``. A failed
capture raises; nothing falls back to the eager forward on the card.
"""

from __future__ import annotations

import threading
import time

import torch

from ..kernels import counts, debug

__all__ = ["CompiledForward", "warm_up", "capture", "WARMUP"]

WARMUP = 2  # eager forwards before a capture


# Every warm-up and capture of the process runs on one side stream per
# card, one at a time: cuBLAS keeps a workspace (32 MiB on the H100) for
# each stream it has run on, for the life of the process, so a new stream
# per capture would hold memory that nothing frees.
_SIDE_STREAMS = {}
_SIDE_LOCK = threading.RLock()


def _side_stream(device):
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def warm_up(fn, x, n):
    """``n`` eager calls of ``fn(x)`` on the side stream of ``x``'s device,
    their launches not counted; the device's current stream then waits for
    them."""
    current = torch.cuda.current_stream(x.device)
    with _SIDE_LOCK:
        side = _side_stream(x.device)
        side.wait_stream(current)
        with counts.recording(), torch.cuda.stream(side):
            for _ in range(n):
                fn(x)
        current.wait_stream(side)


def capture(fn, x, pool=None):
    """``fn(x)`` captured into a new CUDA graph: returns the graph, the
    output it writes and the ledger of the kernels' launches it holds. The
    capture is thread-local (``capture_error_mode="thread_local"``), so
    that other threads may allocate or pin memory meanwhile, and runs on the
    side stream of ``x``'s device; ``pool`` is a memory pool to share with
    other graphs (a private one by default)."""
    graph = torch.cuda.CUDAGraph()
    with _SIDE_LOCK, counts.recording() as ledger, torch.cuda.graph(
            graph, pool=pool, stream=_side_stream(x.device),
            capture_error_mode="thread_local"):
        out = fn(x)
    return graph, out, ledger


class _Graph:
    """One key's graph: its static input and output and its launches."""

    def __init__(self, static_input):
        self.input = static_input
        self.graph = self.output = None
        self.ledger = {}


class CompiledForward:
    """Runs ``fn(x)`` on ``device`` as one CUDA graph per input (shape,
    dtype), like a jitted function's cache of programs.

    ``fn`` takes one tensor on ``device`` and returns one tensor; whatever
    else it reads (weights) it reads in place at every replay. Each key's
    graph has a memory pool of its own. ``x`` may lie on the host or on the
    card; calls are serialised, and each replays on the calling thread's
    current stream. ``compile_s`` maps each key ``(shape, dtype)`` to the
    seconds of its first call: warm-up, capture and the first replay, to
    its end on the card.
    """

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.compile_s = {}
        self._graphs = {}
        self._lock = threading.Lock()

    def _entry(self, key):
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = _Graph(
                torch.empty(key[0], dtype=key[1], device=self.device))
        return entry

    def input_buffer(self, shape, dtype):
        """The static input of the graph at (``shape``, ``dtype``), made
        when first asked for: a batch written into it and passed to the call
        is not copied again."""
        with self._lock:
            return self._entry((tuple(shape), dtype)).input

    def __call__(self, x):
        if debug.enabled():
            raise RuntimeError(debug.NOT_CAPTURED)
        key = (tuple(x.shape), x.dtype)
        with self._lock, torch.cuda.device(self.device):
            entry = self._entry(key)
            if x is not entry.input:
                entry.input.copy_(x, non_blocking=True)
            if entry.graph is None:
                t0 = time.perf_counter()
                warm_up(self.fn, entry.input, WARMUP)
                entry.graph, entry.output, entry.ledger = capture(
                    self.fn, entry.input)
                entry.graph.replay()
                torch.cuda.synchronize(self.device)
                self.compile_s[key] = time.perf_counter() - t0
            else:
                entry.graph.replay()
            counts.add(entry.ledger)
            return entry.output.clone()
