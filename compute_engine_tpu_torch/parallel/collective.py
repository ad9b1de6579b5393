"""Explicit collectives for tensor-parallel binary convolution: the
counterpart of ``compute_engine_tpu.parallel.collective``.

Three TP execution modes over the "model" mesh axis (filters sharded on
output channels):

  gather     activations replicated; each slot computes its channel slice,
             then the slices are gathered on every slot (an all-gather:
             each slot receives the others' slices) and concatenated.
  sharded    like gather but returns the channel-sharded output, each slot
             ``c_out / S`` wide, for chaining into ops that consume shards.
  pipelined  activations sharded on BATCH over the same axis; the packed
             weight shards (32x compressed, far cheaper to move than
             activations) rotate around the ring while each slot convolves
             the shard it holds. Step t's copy to the next slot runs on a
             side stream, with an event for the wait, so it can overlap the
             conv of step t. No all-gather anywhere (the collective log shows
             it). Output: batch-sharded, full channels. With every slot on
             one card the ring can be captured into a CUDA graph.

One process drives every slot (``parallel.mesh``): a collective is a copy
between slots, ``Tensor.to(device, non_blocking=True)``, which PyTorch
orders against both cards' current streams and which goes peer to peer over
NVLink between two cards of a host; between two slots of one device it is a
local copy. JAX's shard_map proves the layout in its compiled program (an
HLO check); here every copy between slots is recorded in ``log``, a list
the caller passes (``record``: one schema for this module and
``parallel.partition``).

The sharded forward of a data group whose slots lie on distinct cards
joins them by NCCL instead (``NcclLinks``): one communicator per card, made
from this process at once (``ncclCommInitAll``), and the all-gather and
broadcast issued on every card's current stream in one NCCL group, so that
a CUDA graph captured on each card holds its own NCCL kernels
(``runtime.compiled.capture_per_card``).
"""

from __future__ import annotations

import ctypes
import sys
import threading

import numpy as np
import torch

from ..core.params import BConv2DParams
from ..core.transforms import OutputTransform
from ..kernels.bgemm import bgemm
from ..ops import bconv2d
from ..runtime.compiled import slot_copy
from .sharding import NamedSharding, ShardedTensor, device_put

__all__ = ["tp_bconv2d", "record", "to_slot", "all_gather", "NcclLinks",
           "NCCL_MIN_VERSION"]


def tp_bconv2d(packed_input, packed_filter, transform: OutputTransform,
               params: BConv2DParams, mesh, axis: str = "model",
               output_kind: str = "float", kernel: str = "auto",
               mode: str = "gather", gemm=bgemm, log=None):
    """Tensor-parallel bconv2d over ``mesh``'s ``axis``.

    Args:
      packed_input: (N, H, W, Cp) int32 words, replicated over ``axis``.
      packed_filter: (O, FH, FW, Cpg) int32 words, global view: axis 0 is
        split over ``axis`` (O must be divisible by the axis size).
      transform: global-view output transform (per-channel arrays are split
        with the filter).
      mode: "gather" (replicated output), "sharded" (channel-sharded) or
        "pipelined" (batch-sharded input and output, weights on a ring).
      kernel, gemm: the lowering and the binary GEMM of every slot's
        ``ops.bconv2d``.
      log: a list that receives one record per copy between slots.

    Returns a ``ShardedTensor``: (N, OH, OW, C_out) replicated [gather],
    channel-sharded [sharded] or batch-sharded [pipelined] (C_out / 32 words
    for bitpacked output); ``.join()`` assembles it.
    """
    n_shards = mesh.shape[axis]
    c_out = packed_filter.shape[0]
    if c_out % n_shards:
        raise ValueError(f"channels_out {c_out} not divisible by mesh axis "
                         f"{axis} of size {n_shards}")
    if mode == "pipelined":
        return _tp_bconv2d_pipelined(packed_input, packed_filter, transform,
                                     params, mesh, axis, output_kind, kernel,
                                     gemm, log)
    if mode not in ("gather", "sharded"):
        raise ValueError(f"unknown mode {mode!r}")
    if output_kind == "bitpacked" and (c_out // n_shards) % 32:
        # Each shard packs its own channel slice into whole words; a partial
        # word per shard would interleave padding bits into the gathered
        # result (the reference's byte-aligned threaded bitpacked writes,
        # `core/bgemm/kernels_common.h:82-95`).
        raise ValueError(
            "bitpacked TP output requires channels_out per shard to be a "
            f"multiple of 32; got {c_out // n_shards}")
    arrays, local_transform = _transform_arrays(transform)
    x = device_put(packed_input, NamedSharding(mesh, ()))
    w = device_put(packed_filter, NamedSharding(mesh, (axis, None, None,
                                                       None)))
    t = [device_put(a, NamedSharding(mesh, (axis,))) for a in arrays]
    ys = [bconv2d(x.shards[i], w.shards[i],
                  local_transform([a.shards[i] for a in t]), params,
                  output_kind=output_kind, kernel=kernel, gemm=gemm)
          for i in range(mesh.size)]
    local = ys[0].shape
    if mode == "sharded":
        return ShardedTensor(mesh, (None, None, None, axis), ys,
                             (*local[:-1], local[-1] * n_shards))
    out = []
    for idx, _ in mesh.slots():
        ring = _ring(mesh, idx, axis)
        out.append(all_gather([ys[_flat(mesh, peer)] for peer in ring], ring,
                              idx, mesh, log))
    return ShardedTensor(mesh, (), out, out[0].shape)


def _tp_bconv2d_pipelined(packed_input, packed_filter, transform, params,
                          mesh, axis, output_kind, kernel, gemm, log):
    """Weight-rotation ring TP: batch-sharded x, filter shards on a ring.

    Each slot holds a batch slice of the activations and one out-channel
    shard of the packed filter (+ its per-channel transform slice). Over S
    ring steps it convolves the shard it currently holds while the next
    shard is already on its way:

        for t in 0..S-1:
            start copy(filter, transforms) -> slot (j + 1) % S   (side stream)
            y[shard (me - t) % S] = bconv2d(x_local, filter_held)
            wait for the copy (event)

    The conv at step t and the copy for step t+1 have no data dependency.
    The rotated payload is the 32x-bitpacked filter + its O/S-long transform
    vectors, far smaller than the activations a gather-based TP would move.
    Output is batch-sharded with full channels, composing with the DP input
    sharding.
    """
    n_shards = mesh.shape[axis]
    c_out = packed_filter.shape[0]
    per = c_out // n_shards
    n = packed_input.shape[0]
    if n % n_shards:
        raise ValueError(f"pipelined TP shards the batch: batch {n} not "
                         f"divisible by mesh axis {axis} of size {n_shards}")
    if output_kind == "bitpacked" and per % 32:
        raise ValueError(
            "bitpacked pipelined TP requires channels_out per shard to be a "
            f"multiple of 32; got {per}")
    arrays, local_transform = _transform_arrays(transform)
    x = device_put(packed_input, NamedSharding(mesh, (axis,)))
    w = device_put(packed_filter, NamedSharding(mesh, (axis, None, None,
                                                       None)))
    t = [device_put(a, NamedSharding(mesh, (axis,))) for a in arrays]
    out = [None] * mesh.size
    for idx, _ in mesh.slots():
        if idx[mesh.axis_names.index(axis)]:
            continue  # one ring per line of slots along the axis
        ring = _ring(mesh, idx, axis)
        slots = [_flat(mesh, r) for r in ring]
        devs = [mesh.devices[r] for r in ring]
        held = [(w.shards[i], *(a.shards[i] for a in t)) for i in slots]
        pieces = [[] for _ in ring]
        for step in range(n_shards):
            sent = None
            if step < n_shards - 1:
                sent = [_send(held[j], ring[j], ring[(j + 1) % n_shards],
                              mesh, log)
                        for j in range(n_shards)]
            for j, i in enumerate(slots):
                w_t, *tr_t = held[j]
                pieces[j].append(bconv2d(
                    x.shards[i], w_t, local_transform(tr_t), params,
                    output_kind=output_kind, kernel=kernel, gemm=gemm))
            if sent is not None:
                # Slot j + 1 receives what slot j sent.
                held = [_receive(*sent[(j - 1) % n_shards], devs[j])
                        for j in range(n_shards)]
        for j, i in enumerate(slots):
            # pieces[t] is the slice owned by shard (me - t) % S; reversed,
            # the concat runs ascending from shard (me + 1) % S, so one
            # channel roll places every slice at its global offset.
            full = torch.cat(pieces[j][::-1], dim=-1)
            width = full.shape[-1]  # c_out, or c_out/32 packed words
            out[i] = torch.roll(full, (j + 1) * (width // n_shards),
                                dims=-1)
    local = out[0].shape
    return ShardedTensor(mesh, (axis,), out, (local[0] * n_shards,
                                              *local[1:]))


def _transform_arrays(transform: OutputTransform):
    """The per-channel arrays of ``transform`` as tensors, and a function
    that builds a slot's transform from its slices of them."""
    if transform.thresholds is not None:
        def local(arrs):
            return OutputTransform(thresholds=arrs[0])

        return [_as_tensor(transform.thresholds)], local

    def local(arrs):
        return OutputTransform(clamp_min=transform.clamp_min,
                               clamp_max=transform.clamp_max,
                               multiplier=arrs[0], bias=arrs[1])

    return [_as_tensor(transform.multiplier),
            _as_tensor(transform.bias)], local


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, order="C"))


def _flat(mesh, idx) -> int:
    return int(np.ravel_multi_index(idx, mesh.devices.shape))


def _ring(mesh, idx, axis):
    """The slots that share ``idx``'s coordinates on every axis but
    ``axis``, in ring order."""
    k = mesh.axis_names.index(axis)
    return [tuple(idx[:k]) + (j,) + tuple(idx[k + 1:])
            for j in range(mesh.shape[axis])]


def record(log, kind, tensors, src, dst, mesh):
    """Append one copy between slots to ``log`` when it is a list:
    ``{"kind", "bytes", "src", "dst", "local"}``, with the two slots' grid
    coordinates and ``local`` when both slots are one device (a local copy,
    or none). ``kind`` is "all_gather", "ppermute" or "broadcast"."""
    if log is not None:
        log.append({"kind": kind, "src": src, "dst": dst,
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in tensors),
                    "local": mesh.devices[src] == mesh.devices[dst]})


def to_slot(t, src, dst, mesh, log=None, kind="broadcast"):
    """``t``, held by slot ``src``, on slot ``dst``'s device: recorded as
    ``kind`` unless the two slots are one. PyTorch orders the copy against
    both devices' current streams; between slots of one device the tensor
    is used where it lies. A capture pass that splits at slots ends a
    segment at every copy between two slots (``runtime.compiled.
    slot_copy``)."""
    out = t.to(mesh.devices[dst], non_blocking=True)
    if src == dst:
        return out
    record(log, kind, [t], src, dst, mesh)
    return slot_copy(out)


def all_gather(pieces, srcs, dst, mesh, log=None, dim=-1):
    """The ``pieces`` that slots ``srcs`` hold, concatenated along ``dim``
    on slot ``dst``: one "all_gather" record per piece from another slot."""
    return torch.cat([to_slot(p, s, dst, mesh, log, "all_gather")
                      for p, s in zip(pieces, srcs)], dim=dim)


# The ring's side stream of each sending card, made at its first use, which
# is eager: a CUDA graph that captures the ring (one card's slots) forks its
# capture into this stream and joins it back at the receive, and creates no
# stream while it captures.
_RING_STREAMS = {}


def _ring_stream(device):
    stream = _RING_STREAMS.get(device)
    if stream is None:
        stream = _RING_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def _send(tensors, src, dst, mesh, log):
    """Start copying ``tensors`` from slot ``src`` to slot ``dst``: on the
    ring's side stream of the sending card, after what that card's current
    stream has queued, with an event to wait for. Returns (copies, event)."""
    record(log, "ppermute", tensors, src, dst, mesh)
    src_dev, dst_dev = mesh.devices[src], mesh.devices[dst]
    if src_dev.type != "cuda":
        return [t.to(dst_dev) if dst_dev != src_dev else t.clone()
                for t in tensors], None
    side = _ring_stream(src_dev)
    side.wait_stream(torch.cuda.current_stream(src_dev))
    with torch.cuda.stream(side):
        copies = [t.to(dst_dev, non_blocking=True) if dst_dev != src_dev
                  else t.clone() for t in tensors]
        for t in tensors:
            t.record_stream(side)  # read there: not reused before the copy
        event = torch.cuda.Event()
        event.record(side)
    return copies, event


def _receive(copies, event, dev):
    """Make ``dev``'s current stream wait for the copy; the copies are then
    used there."""
    if event is not None:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(event)
        for t in copies:
            t.record_stream(stream)
    return tuple(copies)


# -- NCCL between the slots of one group, from this one process ---------------

NCCL_MIN_VERSION = (2, 9)  # CUDA graph capture of NCCL collectives
_NCCL_UINT8 = 1  # ncclUint8: every collective here moves bytes


class _Nccl:
    """The NCCL library that PyTorch loaded, called through ctypes on
    tensors: PyTorch's own ``torch.cuda.nccl`` makes a communicator per rank
    only through ``init_rank``, which fails under Python 3.12
    ("PY_SSIZE_T_CLEAN macro must be defined"), and its communicators made
    at the first collective live as long as the process."""

    def __init__(self):
        lib = ctypes.CDLL("libnccl.so.2")  # PyTorch has loaded it
        ptr = ctypes.c_void_p
        lib.ncclGetErrorString.restype = ctypes.c_char_p
        lib.ncclCommInitAll.argtypes = [ctypes.POINTER(ptr), ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.ncclAllGather.argtypes = [ptr, ptr, ctypes.c_size_t,
                                      ctypes.c_int, ptr, ptr]
        lib.ncclBroadcast.argtypes = [ptr, ptr, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_int, ptr, ptr]
        lib.ncclCommAbort.argtypes = [ptr]
        self.lib = lib

    def _check(self, result):
        if result != 0:
            text = self.lib.ncclGetErrorString(result).decode()
            raise RuntimeError(f"NCCL error {result}: {text}")

    def version(self):
        v = ctypes.c_int()
        self._check(self.lib.ncclGetVersion(ctypes.byref(v)))
        code = v.value  # major * 10000 + minor * 100 + patch since 2.9
        return code // 10000, code // 100 % 100, code % 100

    def init_all(self, devices):
        """One communicator per card of ``devices`` (distinct), rank i on
        ``devices[i]``."""
        n = len(devices)
        comms = (ctypes.c_void_p * n)()
        ids = (ctypes.c_int * n)(*[d.index for d in devices])
        self._check(self.lib.ncclCommInitAll(comms, n, ids))
        return list(comms)

    def release(self, comms):
        """Free ``comms`` once their cards have finished their work:
        ``ncclCommAbort``, which each communicator completes on its own
        (``ncclCommDestroy`` of the communicators of one
        ``ncclCommInitAll``, one after the other from one thread, waits for
        the others' and hangs)."""
        for c in comms:
            self._check(self.lib.ncclCommAbort(c))

    def _group(self, calls):
        self._check(self.lib.ncclGroupStart())
        try:
            for call in calls:
                self._check(call())
        finally:
            self._check(self.lib.ncclGroupEnd())

    def all_gather(self, inputs, outputs, comms):
        """Rank i's ``inputs[i]`` into every ``outputs[j]`` at offset i
        (NCCL's flat rank order), on each card's current stream."""
        self._group([
            lambda i=i, o=o, c=c: self.lib.ncclAllGather(
                i.data_ptr(), o.data_ptr(), i.numel() * i.element_size(),
                _NCCL_UINT8, c, _stream(i))
            for i, o, c in zip(inputs, outputs, comms)])

    def broadcast(self, tensors, comms, root=0):
        """``tensors[root]`` into every other one, in place, on each card's
        current stream."""
        self._group([
            lambda t=t, c=c: self.lib.ncclBroadcast(
                t.data_ptr(), t.data_ptr(), t.numel() * t.element_size(),
                _NCCL_UINT8, root, c, _stream(t))
            for t, c in zip(tensors, comms)])


def _stream(t):
    """The current stream of ``t``'s card, as NCCL takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


_NCCL = []
_NCCL_LOCK = threading.Lock()


def _nccl():
    with _NCCL_LOCK:
        if not _NCCL:
            _NCCL.append(_Nccl())
        return _NCCL[0]


class NcclLinks:
    """NCCL communicators joining the slots of one data group, each slot on
    a distinct card (``devices``, in slot order), made at once and released
    with the object (``close``, or when it goes).

    ``all_gather(pieces)``: slot j's ``pieces[j]`` (..., c), gathered along
    the last axis on every slot; returns the whole (..., j * c) tensor on
    each slot, in slot order. NCCL writes the pieces in rank order, one
    after the other, so each slot's (tp, ..., c) buffer is reordered by one
    copy, the bytes a ``torch.cat`` moves. ``broadcast(t)``: ``t``, on the
    first slot, on every slot (``t`` itself on the first). Both are issued
    on each card's current stream: captured, on the capturing one.
    """

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if len(set(self.devices)) != len(self.devices):
            raise ValueError(f"NCCL joins distinct cards, one rank each; got "
                             f"{[str(d) for d in self.devices]}")
        self._lib = _nccl()
        version = self._lib.version()
        if version < NCCL_MIN_VERSION:
            raise RuntimeError(f"NCCL {version} cannot be captured into a "
                               f"CUDA graph; {NCCL_MIN_VERSION} or later can")
        self._comms = self._lib.init_all(self.devices)

    def close(self):
        """Release the communicators, after every card's queued work (no
        replay may use them after)."""
        comms, self._comms = self._comms, []
        if comms:
            for d in self.devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self._lib.release(comms)

    def __del__(self):
        # At interpreter exit the process takes the communicators with it:
        # a CUDA call then may never return.
        if getattr(self, "_comms", None) and not sys.is_finalizing():
            self.close()

    @property
    def closed(self):
        return not self._comms

    def all_gather(self, pieces):
        pieces = [p.contiguous() for p in pieces]
        shape = pieces[0].shape
        flat = [torch.empty((len(pieces), *shape), dtype=p.dtype,
                            device=p.device) for p in pieces]
        self._lib.all_gather(pieces, flat, self._comms)
        return [f.movedim(0, -2).reshape(*shape[:-1], -1) for f in flat]

    def broadcast(self, t):
        t = t.contiguous()
        bufs = [t] + [torch.empty(t.shape, dtype=t.dtype, device=d)
                      for d in self.devices[1:]]
        self._lib.broadcast(bufs, self._comms)
        return bufs
