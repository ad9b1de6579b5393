"""The compiled forward: captured CUDA graphs per input shape and dtype.

The port's counterpart of ``jax.jit`` as the JAX runtime uses it: JAX's
``Interpreter`` jits its forward once per batch shape, with the weights as
jit arguments, and its ``ShardedInterpreter`` jits the sharded forward over
the mesh. Here the first call at an input (shape, dtype) runs the forward
eagerly a few times on a side stream per card (``warm_up_plan``: the
kernels are built or loaded, cuDNN and cuBLAS initialise, the kernels'
shared-memory attributes are set, NCCL connects), then captures it into
``torch.cuda.CUDAGraph`` objects. Every call copies its input into the
static input and replays the graphs, on the calling thread without
waiting: one launch for the host per graph, where the eager forward has
60-100.

The weights are read where they lie, by address, as jit arguments are: a
``copy_`` into a weight changes what the next replay computes (replacing
the tensor in a layer dict does not). Each call returns a fresh tensor, a
clone of the graphs' output, as jit returns a fresh array.

A call runs in parts (``CompiledParts``), each with a static input: the
whole forward where every slot is one device, else one part per data
group (``ShardedInterpreter``). A part is captured one of three ways:

* one device: one graph (``capture_plan`` finds one segment);
* distinct cards joined by NCCL collectives (``per_card``): one graph per
  card, every card's capture open at once on its side stream
  (``capture_per_card``), so that each card's graph holds its own NCCL
  kernels; a replay of one card's graph waits in those kernels for its
  peers, so a call replays every card's graph;
* otherwise (a data group whose slots repeat a card, or the split plan
  that ``split`` asks for): segments (``capture_plan``). One capture cannot
  hold a copy between two cards (the caching allocator of the other card
  is not in capture mode, and the copy joins the other card's stream into
  the capture), so a segment is the run of one device's work between two
  copies that cross devices, one graph on that device's side stream, and
  the copies between segments run outside any graph, from one segment's
  output into a buffer that the next one reads. Which device an operation
  runs on, and which copies cross devices, is read off the operations
  themselves as the capture pass runs them (``_Segmenter``, a dispatch
  mode); ``split`` ends a segment where the forward asks for it.

An NCCL collective is no operation the dispatch mode sees: it is issued on
each card's current stream, the capturing one during a capture. The
warm-up's plan of a ``per_card`` part must hold no copy between cards. The
plan of a segment capture must be the plan of its warm-up. ``host_steps``
counts the replays and copies of one call: 1 where the whole forward is one
graph, the number of cards for a ``per_card`` part.

Launch counts (``kernels.counts``): a capture's launches are recorded into
a ledger, not counted, and every replay adds the ledger. The warm-up
forwards are the compile step and are not counted either, so the counts
hold the forwards the caller asked for.

Profiler spans (``utils.profiling``): while a profiler runs, every call
records its own host path at that call, ``compiled/lock`` (waiting for the
lock), ``compiled/input_copy`` (the copies into the static inputs),
``compiled/replay`` (every step's replay or copy and the launch ledger; at
a key's first call also its compile) and ``compiled/output`` (the clone or
the concatenation of the outputs). Spans inside the forward
(``utils.profiling.annotate``) are recorded once, at the capture, and not
at the replays, which run no Python: profile by kernel name through
``packed_apply``.

What a graph cannot hold: the kernels' debug builds wait for each launch
to read their error word, so a call inside ``kernels.debug_checks()``
raises (debug checks stay an eager ``packed_apply`` tool). A failed capture
raises; nothing falls back to the eager forward on the card.
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
from ..utils.profiling import _spans

__all__ = ["CompiledForward", "CompiledParts", "warm_up_plan",
           "capture_plan", "capture_per_card", "split", "slot_copy", "PLANS",
           "WARMUP"]

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
    own. An operation that reads tensors on two of them is refused. With
    ``at_slots`` every copy between two slots of a mesh (``slot_copy``)
    ends a segment too, on one card as well.
    """

    def __init__(self, devices, pools=None, at_slots=False):
        super().__init__()
        self.devices = frozenset(devices)
        self.pools = pools
        self.at_slots = at_slots
        self.steps = []
        self._open = None
        self._split = False
        self._outer = None

    def __enter__(self):
        self._outer = getattr(_LOCAL, "segmenter", None)
        _LOCAL.segmenter = self
        if len(self.devices) == 1:
            # One device: the pass is one segment from its start, so that a
            # kernel launched before any operation is in it too.
            self._begin(next(iter(self.devices)))
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


def slot_copy(t):
    """``t``, just copied from one slot of a mesh to another
    (``parallel.collective.to_slot``): through ``split`` in a pass that
    splits at slots (a part of ``CompiledParts`` whose plan is
    "split_at_slots"), else ``t`` itself."""
    seg = getattr(_LOCAL, "segmenter", None)
    return seg.split(t) if seg is not None and seg.at_slots else t


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


def warm_up_plan(fn, x, devices, n, at_slots=False):
    """``n`` eager calls of ``fn(x)`` on the side streams of ``devices``,
    their launches not counted; returns the plan the last one went through
    (its steps, with no graphs), split at slots with ``at_slots``."""
    with _SIDE_LOCK, counts.recording(), _on_side_streams(devices):
        for _ in range(n):
            seg = _Segmenter(devices, at_slots=at_slots)
            with seg:
                fn(x)
            seg.close()
    return seg.steps


def capture_plan(fn, x, devices, pools, at_slots=False):
    """``fn(x)`` captured as a plan over ``devices`` (``_Segmenter``, split
    at slots with ``at_slots``), each segment's graph in the memory pool
    ``pools`` gives its device: returns the steps and the output the last
    one writes. A failed capture raises, and so does a kernel launched
    outside every segment (it would not be replayed)."""
    seg = _Segmenter(devices, pools, at_slots)
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


def capture_per_card(fn, x, devices, pools):
    """``fn(x)`` captured into one graph per card of ``devices``, every
    card's capture open at once on its side stream, each graph in the
    memory pool ``pools`` gives its card: returns the steps (one segment
    per card, in the order of ``devices``, the launch ledger on the first)
    and the output. Each capture begins and ends with its own card current
    (a tensor method makes its tensor's card current). The graphs are
    instantiated once every capture has ended: instantiating is no call a
    thread may make while it captures. A failed capture raises, after every
    capture has ended."""
    segs = [_Segment(d) for d in devices]
    opened = []
    with _SIDE_LOCK, counts.recording(capture=True) as ledger, \
            _on_side_streams(devices):
        for d in devices:
            torch.cuda.synchronize(d)
        try:
            for seg in segs:
                seg.graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.device(seg.device):
                    seg.graph.capture_begin(
                        pools[seg.device], capture_error_mode="thread_local")
                opened.append(seg)
            out = fn(x)
        except BaseException:
            _end_captures(opened, quiet=True)
            raise
        _end_captures(opened)
        for seg in segs:
            with torch.cuda.device(seg.device):
                seg.graph.instantiate()
    segs[0].ledger = dict(ledger)
    return segs, out


def _end_captures(segs, quiet=False):
    """End each capture of ``segs``, the last begun first; then raise the
    first failure unless ``quiet``."""
    error = None
    for seg in reversed(segs):
        try:
            with torch.cuda.device(seg.device):
                seg.graph.capture_end()
        except RuntimeError as e:
            error = error or e
    if error is not None and not quiet:
        raise error


def _indexed(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


PLANS = ("segments", "split_at_slots", "per_card")


class _Part:
    """A part of a call: ``fn`` on its static input on ``home``, running on
    ``devices`` (in slot order), captured by ``plan``: "segments"
    (``capture_plan``), "split_at_slots" (segments split at every copy
    between slots too) or "per_card" (``capture_per_card``)."""

    def __init__(self, fn, home, devices, plan="segments"):
        if plan not in PLANS:
            raise ValueError(f"unknown plan {plan!r}; expected one of {PLANS}")
        self.fn, self.home = fn, _indexed(home)
        self.devices = tuple(dict.fromkeys(map(_indexed, devices)))
        self.plan = plan


class _Plan:
    """One key's plan: each part's static input, steps and output."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.steps = self.outputs = None


class CompiledParts:
    """Runs a forward in ``parts`` as CUDA graphs, one plan per input
    (shape, dtype), as the module docstring says.

    Each part is ``(fn, home, devices)`` or ``(fn, home, devices, plan)``:
    ``fn`` takes its share of the batch (the batch split evenly over the
    parts along its first axis) on ``home`` and returns a tensor there,
    running on ``devices``; ``plan`` says how it is captured (``_Part``):
    as segments by default, as one graph per card for distinct cards that
    ``fn`` joins by NCCL collectives ("per_card"). A call copies each share
    into its part's static input, issues every part's replays and copies
    and returns a fresh tensor on ``device``: the outputs of the parts
    concatenated there. Weights are read in place. ``compile_s`` maps each key to the
    seconds of its first call (every part's warm-up and capture, and the
    first replays, to their end on the cards), ``host_steps`` and
    ``graphs`` to the replays and copies, and the graphs, of one call. The
    plan a segment capture finds must be the plan of its warm-up, and the
    warm-up of a ``per_card`` part must copy nothing between cards, or the
    call raises.
    """

    def __init__(self, parts, device):
        self.parts = [_Part(*p) for p in parts]
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
                torch.empty(share, dtype=dtype, device=p.home)
                for p in self.parts])
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
        for p, x in zip(self.parts, plan.inputs):
            for d in p.devices:
                if d not in pools:
                    pools[d] = torch.cuda.graph_pool_handle()
            at_slots = p.plan == "split_at_slots"
            want = _signature(warm_up_plan(p.fn, x, p.devices, WARMUP,
                                           at_slots))
            if p.plan == "per_card":
                copies = [s for s in want if s[0] == "copy"]
                if copies:
                    raise RuntimeError(
                        f"a forward captured as one graph per card copies "
                        f"between cards: {copies}")
                part, out = capture_per_card(p.fn, x, p.devices, pools)
            else:
                part, out = capture_plan(p.fn, x, p.devices, pools, at_slots)
            if p.plan != "per_card" and _signature(part) != want:
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
        return self._call(x, _spans())

    def _call(self, x, span):
        """The forward of ``x``, its stages in the spans of ``span``, the
        span maker of a caller that has checked for a profiler already
        (``Interpreter.__call__``)."""
        if debug.enabled():
            raise RuntimeError(debug.NOT_CAPTURED)
        key = (tuple(x.shape), x.dtype)
        with span("compiled/lock"):
            self._lock.acquire()
        try:
            plan = self._plan(key)
            per = x.shape[0] // len(plan.inputs)
            with span("compiled/input_copy"):
                for p, buf in enumerate(plan.inputs):
                    if x is not buf:
                        buf.copy_(x[p * per:(p + 1) * per], non_blocking=True)
            with span("compiled/replay"):
                if plan.steps is None:
                    self._first_run(plan, key)
                else:
                    self._run(plan)
            with span("compiled/output"):
                if len(plan.outputs) == 1:
                    return plan.outputs[0].clone()
                return torch.cat([o.to(self.device, non_blocking=True)
                                  for o in plan.outputs])
        finally:
            self._lock.release()

    def _first_run(self, plan, key):
        """Compiles ``key``'s plan, replays it and waits for the cards: the
        seconds of it all are the key's ``compile_s``."""
        t0 = time.perf_counter()
        self._compile(plan)
        self._run(plan)
        for d in {d for p in self.parts for d in p.devices}:
            torch.cuda.synchronize(d)
        self.compile_s[key] = time.perf_counter() - t0
        self.host_steps[key] = sum(map(len, plan.steps))
        self.graphs[key] = sum(isinstance(s, _Segment)
                               for part in plan.steps for s in part)


class CompiledForward(CompiledParts):
    """``fn(x)`` on ``device`` as one CUDA graph per input (shape, dtype),
    like a jitted function's cache of programs: the one-part
    ``CompiledParts`` that ``Interpreter`` runs."""

    def __init__(self, fn, device):
        super().__init__([(fn, device, [device])], device)
