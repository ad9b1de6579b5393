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

The sharded forward (``CompiledParts``, behind ``ShardedInterpreter``) runs
on several slots, and one capture cannot hold kernels on two cards: the
caching allocator of the other card is not in capture mode, and a copy
between cards joins the other card's stream into the capture. So a call is
split into parts, each with a static input (the whole forward where every
slot is one device, else one part per data group), and each part is
captured as segments (``capture_plan``): a segment is the run of one
device's work between two copies that cross devices, one graph on that
device's side stream, and the copies between segments run outside any
graph, from one segment's output into a buffer that the next one reads.
Which device an operation runs on, and which copies cross devices, is read
off the operations themselves as the capture pass runs them
(``_Segmenter``, a dispatch mode); ``split`` ends a segment where the
forward asks for it. The replay plan of a part is its segments and copies
in the forward's own order; a call issues every part's plan on the calling
thread without waiting, each replay on its device's current stream and
each copy ordered by PyTorch against both devices' current streams, so the
cards run at once. ``host_steps`` counts the replays and copies of one
call: 1 where the whole forward is one graph.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import counts, debug

__all__ = ["CompiledForward", "CompiledParts", "warm_up", "capture",
           "warm_up_plan", "capture_plan", "split", "WARMUP"]

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
    with _SIDE_LOCK, counts.recording(capture=True) as ledger, \
            torch.cuda.graph(graph, pool=pool, stream=_side_stream(x.device),
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


# -- several graphs for one call ---------------------------------------------

_ATEN = torch.ops.aten
_COPIES = (_ATEN.to, _ATEN._to_copy, _ATEN.copy_)
_LOCAL = threading.local()  # the segmenter of this thread's pass, if any


class _Segment:
    """A step of a plan: one device's run of work, captured as a graph."""

    def __init__(self, device):
        self.device = device
        self.graph = None
        self.ledger = {}

    def run(self):
        self.graph.replay()
        counts.add(self.ledger)


class _Copy:
    """A step of a plan: a copy between segments, from what an earlier one
    wrote (``src``) into a buffer that a later one reads (``dst``)."""

    def __init__(self, src, dst):
        self.src, self.dst = src, dst

    def run(self):
        self.dst.copy_(self.src, non_blocking=True)


def _signature(steps):
    """What a plan does, without its tensors: to hold the plan of a capture
    against the plan of its warm-up."""
    return [("graph", s.device) if isinstance(s, _Segment) else
            ("copy", s.src.device, s.dst.device, tuple(s.src.shape))
            for s in steps]


class _Segmenter(TorchDispatchMode):
    """Splits one pass of a forward into the steps of a plan.

    ``devices`` are the devices whose work is captured; ``pools`` maps each
    to the memory pool that its graphs share (they replay in the order they
    were captured), or is None to find the plan of an eager pass (a warm-up)
    without capturing anything. An operation on one of ``devices`` opens a
    segment there unless one is open there already (a view too: an op whose
    schema may alias its input, as ``aten.to.dtype``, can also launch a
    kernel); a copy between two of them, or a copy that ``split`` asks for,
    closes the open segment and runs outside any graph, as a step of its
    own. An operation that reads tensors on two of them is refused.
    """

    def __init__(self, devices, pools=None):
        super().__init__()
        self.devices = frozenset(devices)
        self.pools = pools
        self.steps = []
        self._open = None
        self._split = False
        self._outer = None

    def __enter__(self):
        self._outer = getattr(_LOCAL, "segmenter", None)
        _LOCAL.segmenter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _LOCAL.segmenter = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        found = {x if isinstance(x, torch.device) else x.device
                 for x in tree_leaves((args, kwargs))
                 if isinstance(x, (torch.Tensor, torch.device))}
        found &= self.devices
        # A copy between two of the devices (``Tensor.to`` reaches the mode
        # as an overload of ``aten.to`` or as ``aten._to_copy``), or one
        # that ``split`` asks for.
        if ((len(found) == 2 and func.overloadpacket in _COPIES)
                or (self._split and func is _ATEN.clone.default)):
            self.close()
            out = func(*args, **kwargs)
            self.steps.append(_Copy(args[1], args[0])
                              if func.overloadpacket is _ATEN.copy_
                              else _Copy(args[0], out))
            return out
        if len(found) > 1:
            raise RuntimeError(
                f"{func} reads tensors on {sorted(map(str, found))}: a "
                "captured forward moves data between devices by copies only")
        if found:
            device = found.pop()
            if self._open is None or self._open.device != device:
                self.close()
                self._begin(device)
        return func(*args, **kwargs)

    def _begin(self, device):
        seg = _Segment(device)
        if self.pools is not None:
            seg.graph = torch.cuda.CUDAGraph()
            seg.capturing = torch.cuda.graph(
                seg.graph, pool=self.pools[device],
                stream=_side_stream(device),
                capture_error_mode="thread_local")
            # The op that opens the segment may have made another card
            # current (a tensor method does): begin and end each capture
            # with its own card current.
            with torch.cuda.device(device):
                seg.capturing.__enter__()
        seg.recording = counts.recording(capture=self.pools is not None)
        seg.ledger = seg.recording.__enter__()
        self._open = seg

    def close(self, exc=(None, None, None)):
        """End the open segment, if any: its capture ends (and raises if it
        failed)."""
        seg, self._open = self._open, None
        if seg is None:
            return
        seg.recording.__exit__(None, None, None)
        self.steps.append(seg)
        if seg.graph is not None:
            capturing = seg.capturing
            del seg.capturing
            with torch.cuda.device(seg.device):
                capturing.__exit__(*exc)

    def split(self, t):
        self._split = True
        try:
            return t.clone()
        finally:
            self._split = False


def split(t):
    """``t`` through a copy that ends the segment this thread is capturing,
    so that the work after it is a segment of its own, with the copy a step
    of the plan between them (``t`` itself outside a pass of
    ``CompiledParts``)."""
    seg = getattr(_LOCAL, "segmenter", None)
    return t if seg is None else seg.split(t)


@contextlib.contextmanager
def _on_side_streams(devices):
    """Each card of ``devices`` runs on its side stream inside the block,
    after what its current stream has queued; the current streams wait for
    the side streams after it."""
    cards = [d for d in devices if d.type == "cuda"]
    current = {d: torch.cuda.current_stream(d) for d in cards}
    try:
        with contextlib.ExitStack() as stack:
            for d in cards:
                side = _side_stream(d)
                side.wait_stream(current[d])
                stack.enter_context(torch.cuda.stream(side))
            yield
    finally:
        for d in cards:
            current[d].wait_stream(_side_stream(d))


def warm_up_plan(fn, x, devices, n):
    """``n`` eager calls of ``fn(x)`` on the side streams of ``devices``,
    their launches not counted; returns the plan the last one went through
    (its steps, with no graphs)."""
    with _SIDE_LOCK, counts.recording(), _on_side_streams(devices):
        for _ in range(n):
            seg = _Segmenter(devices)
            with seg:
                fn(x)
            seg.close()
    return seg.steps


def capture_plan(fn, x, devices, pools):
    """``fn(x)`` captured as a plan over ``devices`` (``_Segmenter``), each
    segment's graph in the memory pool ``pools`` gives its device: returns
    the steps and the output the last one writes. A failed capture raises,
    and so does a kernel launched outside every segment (it would not be
    replayed)."""
    seg = _Segmenter(devices, pools)
    with _SIDE_LOCK, counts.recording() as stray, _on_side_streams(devices):
        try:
            with seg:
                out = fn(x)
        except BaseException:
            seg.close(sys.exc_info())
            raise
        seg.close()
    if stray:
        raise RuntimeError(f"kernels launched outside every captured "
                           f"segment: {stray}")
    return seg.steps, out


def _indexed(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Plan:
    """One key's plan: each part's static input, steps and output."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.steps = self.outputs = None


class CompiledParts:
    """Runs a forward in ``parts`` as CUDA graph segments, one plan per
    input (shape, dtype), as the module docstring says.

    Each part is ``(fn, home, devices)``: ``fn`` takes its share of the
    batch (the batch split evenly over the parts along its first axis) on
    ``home`` and returns a tensor there, running on ``devices``. A call
    copies each share into its part's static input, issues every part's
    replays and copies and returns a fresh tensor on ``device``: the
    outputs of the parts concatenated there. Weights are read in place.
    ``compile_s`` maps each key to the seconds of its first call (every
    part's warm-up and capture, and the first replays, to their end on the
    cards), ``host_steps`` and ``graphs`` to the replays and copies, and
    the graphs, of one call. The plan a capture finds must be the plan of
    its warm-up, or the call raises.
    """

    def __init__(self, parts, device):
        self.parts = [(fn, _indexed(home), frozenset(map(_indexed, devs)))
                      for fn, home, devs in parts]
        self.device = _indexed(device)
        self.compile_s = {}
        self.host_steps = {}
        self.graphs = {}
        self._plans = {}
        self._lock = threading.Lock()

    def _plan(self, key):
        plan = self._plans.get(key)
        if plan is None:
            shape, dtype = key
            n = len(self.parts)
            if not shape or shape[0] % n:
                raise ValueError(f"batch {shape[:1]} not divisible into "
                                 f"{n} parts")
            share = (shape[0] // n, *shape[1:])
            plan = self._plans[key] = _Plan([
                torch.empty(share, dtype=dtype, device=home)
                for _, home, _ in self.parts])
        return plan

    def input_buffer(self, shape, dtype):
        """With one part, its static input at (``shape``, ``dtype``): a
        batch written there and passed to the call is not copied again;
        None with several parts."""
        if len(self.parts) != 1:
            return None
        with self._lock:
            return self._plan((tuple(shape), dtype)).inputs[0]

    def _compile(self, plan):
        pools, steps, outputs = {}, [], []
        for (fn, _, devices), x in zip(self.parts, plan.inputs):
            for d in devices:
                if d not in pools:
                    pools[d] = torch.cuda.graph_pool_handle()
            want = _signature(warm_up_plan(fn, x, devices, WARMUP))
            part, out = capture_plan(fn, x, devices, pools)
            if _signature(part) != want:
                raise RuntimeError(
                    f"the plan found at capture, {_signature(part)}, is not "
                    f"the plan of the warm-up, {want}")
            steps.append(part)
            outputs.append(out)
        plan.steps, plan.outputs = steps, outputs

    @staticmethod
    def _run(plan):
        # The buffers between segments were made in the forward's inference
        # mode.
        with torch.inference_mode():
            for part in plan.steps:
                for step in part:
                    step.run()

    def __call__(self, x):
        if debug.enabled():
            raise RuntimeError(debug.NOT_CAPTURED)
        key = (tuple(x.shape), x.dtype)
        with self._lock:
            plan = self._plan(key)
            per = x.shape[0] // len(plan.inputs)
            for p, buf in enumerate(plan.inputs):
                if x is not buf:
                    buf.copy_(x[p * per:(p + 1) * per], non_blocking=True)
            if plan.steps is None:
                t0 = time.perf_counter()
                self._compile(plan)
                self._run(plan)
                for d in set().union(*(devs for *_, devs in self.parts)):
                    torch.cuda.synchronize(d)
                self.compile_s[key] = time.perf_counter() - t0
                self.host_steps[key] = sum(map(len, plan.steps))
                self.graphs[key] = sum(isinstance(s, _Segment)
                                       for part in plan.steps for s in part)
            else:
                self._run(plan)
            if len(plan.outputs) == 1:
                return plan.outputs[0].clone()
            return torch.cat([o.to(self.device, non_blocking=True)
                              for o in plan.outputs])
