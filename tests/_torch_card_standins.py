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

Graphs captured at once (``capture_begin`` on several cards before any
``capture_end``, as ``runtime.compiled.capture_per_card`` does) share one
record of the operations, in program order: on the CPU every slot's tensors
lie on one device, so nothing tells which card an operation ran on. Their
replays then behave as the cards' graphs joined by NCCL do: nothing runs
until every one of them has been replayed, and then all of it runs, in the
order the forward ran it (a replay of one card's graph alone would wait in
its NCCL kernels for its peers). ``FakeNccl`` stands in for the NCCL
library (``parallel.collective._Nccl``) on ``cpu`` tensors: the all-gather
writes rank i's bytes at offset i of every output, NCCL's flat rank order,
and every call checks the communicators' ranks and that none was released.
"""

import contextlib
import sys
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from compute_engine_tpu_torch.parallel import collective
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


@torch.inference_mode()
def _rerun(ops):
    for func, args, kwargs, outs in ops:
        new = func(*args, **kwargs)
        new = new if isinstance(new, (tuple, list)) else (new,)
        for old, now in zip(outs, [t for t in new
                                   if isinstance(t, torch.Tensor)]):
            if old is not now:
                old.copy_(now)


class _Together:
    """The graphs of captures open at once, and their shared record."""

    def __init__(self):
        self.ops, self.graphs, self.open, self.pending = [], [], 0, set()
        self.tape = _Tape(self.ops)


_RECORD = {}  # install()'s record, for the captures that begin and end


class FakeGraph:
    """Stand-in for ``torch.cuda.CUDAGraph``: captured by ``graph`` (one at
    a time) or by ``capture_begin``/``capture_end`` (several at once)."""

    made = []

    def __init__(self, keep_graph=False):
        self.ops, self.replays = [], 0
        self.together = self.device = None
        FakeGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        _RECORD["captures"].append((threading.current_thread().name, pool,
                                    capture_error_mode))
        state = _state()
        self.device = state.current
        state.captures.append(self.device)
        together = getattr(state, "together", None)
        if together is None:
            together = state.together = _Together()
            together.tape.__enter__()
        together.graphs.append(self)
        together.open += 1
        self.together = together

    def capture_end(self):
        state = _state()
        state.captures.remove(self.device)
        together = self.together
        together.open -= 1
        if not together.open:
            together.tape.__exit__(None, None, None)
            state.together = None
        if _RECORD["fail"]:
            raise RuntimeError(_RECORD["fail"])

    def instantiate(self):
        assert not _state().captures, "instantiated while capturing"

    def replay(self):
        self.replays += 1
        together = self.together
        if together is None:
            _rerun(self.ops)
            return
        together.pending.add(self)
        if len(together.pending) == len(together.graphs):
            together.pending.clear()
            _rerun(together.ops)


class FakeComm:
    def __init__(self, rank, n, device):
        self.rank, self.n, self.device = rank, n, device
        self.released = False


class FakeNccl:
    """Stand-in for ``parallel.collective._Nccl`` on ``cpu`` tensors."""

    def version(self):
        return (2, 28, 9)

    def init_all(self, devices):
        comms = [FakeComm(r, len(devices), d) for r, d in enumerate(devices)]
        _RECORD["comms"].append(comms)
        return comms

    def release(self, comms):
        for c in comms:
            assert not c.released
            c.released = True

    @staticmethod
    def _check(tensors, comms):
        assert [c.rank for c in comms] == list(range(len(tensors)))
        assert all(c.n == len(tensors) and not c.released for c in comms)
        assert all(t.is_contiguous() for t in tensors)

    def all_gather(self, inputs, outputs, comms):
        self._check(inputs, comms)
        self._check(outputs, comms)
        nbytes = inputs[0].numel() * inputs[0].element_size()
        for o in outputs:
            assert o.numel() * o.element_size() == len(inputs) * nbytes
            flat = o.view(-1).view(torch.uint8)
            for r, i in enumerate(inputs):
                flat[r * nbytes:(r + 1) * nbytes].copy_(
                    i.view(-1).view(torch.uint8))

    def broadcast(self, tensors, comms, root=0):
        self._check(tensors, comms)
        for r, t in enumerate(tensors):
            assert t.shape == tensors[root].shape
            if r != root:
                t.copy_(tensors[root])


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
    """The card's graph, stream and event objects and the NCCL library
    replaced by the stand-ins; returns the record of captures (thread, pool,
    error mode per capture), ``"fail"``, a message that makes every capture
    raise, and ``"comms"``, the communicator sets made."""
    record = {"captures": [], "fail": None, "comms": []}
    monkeypatch.setattr(sys.modules[__name__], "_RECORD", record)
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
    nccl = FakeNccl()
    monkeypatch.setattr(collective, "_nccl", lambda: nccl)
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
