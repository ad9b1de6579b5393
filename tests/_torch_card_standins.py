"""Stand-ins for the card's CUDA graph, stream and event objects, put in by
``monkeypatch`` so that the compiled forwards (``runtime.compiled``) run on
the CPU in the tests (``test_torch_compiled.py``,
``test_torch_sharded_compiled.py``).

The stand-in graph records every operation of its capture (a
``TorchDispatchMode``) and a replay runs them again on the same tensors,
writing each result into the tensor the capture produced: what a CUDA graph
does with its kernels and their addresses. It refuses a host read of a
tensor's value inside a capture, as a capture on the card does. Streams
carry their device, and ``torch.cuda.is_current_stream_capturing`` is true
while this thread captures on the device made current by
``torch.cuda.device`` (on any device where none was made current, as on a
machine of one card).
"""

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from compute_engine_tpu_torch.runtime import compiled


class _Tape(TorchDispatchMode):
    """Records each operation with its arguments and the tensors it made."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a captured forward read a tensor's value on "
                               "the host")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        made = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((func, args, kwargs,
                         [t for t in made if isinstance(t, torch.Tensor)]))
        return out


class FakeGraph:
    """Stand-in for ``torch.cuda.CUDAGraph``."""

    made = []

    def __init__(self):
        self.ops, self.replays = [], 0
        FakeGraph.made.append(self)

    @torch.inference_mode()
    def replay(self):
        self.replays += 1
        for func, args, kwargs, outs in self.ops:
            new = func(*args, **kwargs)
            new = new if isinstance(new, (tuple, list)) else (new,)
            for old, now in zip(outs, [t for t in new
                                       if isinstance(t, torch.Tensor)]):
                if old is not now:
                    old.copy_(now)


class FakeStream:
    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)

    def wait_stream(self, other):
        pass


_THREAD = threading.local()  # this thread's current device and captures


def _state():
    if not hasattr(_THREAD, "captures"):
        _THREAD.current, _THREAD.captures = None, []
    return _THREAD


@contextlib.contextmanager
def _device(d):
    state = _state()
    saved, state.current = state.current, torch.device(d)
    try:
        yield
    finally:
        state.current = saved


def _capturing():
    state = _state()
    if state.current is None:
        return bool(state.captures)
    return state.current in state.captures


class FakeEvent:
    """Stand-in for ``torch.cuda.Event``: ``elapsed_time`` hands out the
    queued times."""

    queue = []

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return FakeEvent.queue.pop(0) if FakeEvent.queue else 0.0


def install(monkeypatch):
    """The card's graph, stream and event objects replaced by the
    stand-ins; returns the record of captures (thread, pool, error mode per
    capture) and ``"fail"``, a message that makes every capture raise."""
    record = {"captures": [], "fail": None}
    FakeGraph.made = []
    FakeEvent.queue = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        record["captures"].append((threading.current_thread().name, pool,
                                   capture_error_mode))
        captures = _state().captures
        captures.append(None if stream is None else stream.device)
        try:
            with _Tape(g.ops):
                yield
        finally:
            captures.pop()
        if record["fail"]:
            raise RuntimeError(record["fail"])

    monkeypatch.setattr(compiled, "_SIDE_STREAMS", {})
    for name, value in {
            "CUDAGraph": FakeGraph, "graph": graph,
            "graph_pool_handle": lambda: "pool", "Stream": FakeStream,
            "current_stream": FakeStream,
            "stream": lambda s: contextlib.nullcontext(),
            "device": _device,
            "is_current_stream_capturing": _capturing,
            "synchronize": lambda d=None: None, "Event": FakeEvent,
            "get_device_name": lambda d=None: "stand-in card",
            "max_memory_allocated": lambda d=None: 3 * 2 ** 20,
            "reset_peak_memory_stats": lambda d=None: None}.items():
        monkeypatch.setattr(torch.cuda, name, value)
    return record
