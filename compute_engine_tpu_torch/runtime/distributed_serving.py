"""Multi-device / multi-host serving composition: the counterpart of
``compute_engine_tpu.runtime.distributed_serving``.

Glues together:
  * a DP/TP mesh over device slots (``parallel.mesh``),
  * TP-sharded packed weights (``parallel.sharding``) and the sharded
    forward (``parallel.partition``),
  * the continuous-batching front end (``runtime.serving``),
  * host health monitoring with re-sharding on loss (``runtime.health``).

One process drives every slot, as in JAX's single-controller model. Host
loss rebuilds the mesh over the surviving hosts' devices; continuous
batching keeps absorbing requests during the switch (a batch in flight on
the old interpreter finishes; the queue drains onto the new one).

On the card the sharded forward is compiled, as JAX jits it over the mesh:
the first call at an input (shape, dtype) warms up and captures it into
CUDA graphs, and every later call replays them (``runtime.compiled``).
How depends on where the slots lie (``plan_case``): where every slot is one
card, the whole forward is one graph (case A); where each data group's
slots are one card, each group is a graph on its card, the groups' graphs
replayed one after the other without waiting, so that the cards run at
once (B); where a group's slots span cards (C), a group on distinct cards
is joined by NCCL (``parallel.collective.NcclLinks``: the communicators
are made with the interpreter, outside any capture, and released with it)
and captured as one graph per card, every card's capture open at once, as
GSPMD's one program all-gathers on the device. A group whose slots repeat
a card cannot be joined by NCCL, which takes one rank per card: it is
captured as segments, one graph per card's run of work between two copies
that cross cards, with the copies between them. The server captures on its
batcher thread, and a reshard's new interpreter, with communicators of its
own, captures at its first batch, as JAX jits again after a reshard.
"""

from __future__ import annotations

import logging
import threading
import weakref

import numpy as np
import torch

from ..models import get_model, prepare_runtime_arrays
from ..models.zoo import ModelSpec
from ..parallel import make_mesh, shard_artifact
from ..parallel.mesh import visible_cards
from ..parallel.partition import group_apply, partition_layers, sharded_apply
from ..parallel.collective import NcclLinks
from .compiled import CompiledParts
from .health import HeartbeatMonitor
from .serving import ServingEngine

__all__ = ["ShardedInterpreter", "MultiHostServer", "plan_case"]


def plan_case(groups, split_at_slots=False):
    """How the sharded forward over ``groups`` compiles, ``groups`` being
    each data group's slot devices: None where a slot is not a card
    (nothing is captured), "A" where every slot is one card, "B" where each
    group's slots are one card, "C" where a group's slots span cards or
    ``split_at_slots`` asks for segments (see the module docstring: in C a
    group on distinct cards is one graph per card, any other group
    segments). A card named without an index is card 0."""
    groups = [[torch.device(d) for d in g] for g in groups]
    if any(d.type != "cuda" for g in groups for d in g):
        return None
    if split_at_slots:
        return "C"
    cards = [{d.index or 0 for d in g} for g in groups]
    if len(set().union(*cards)) == 1:
        return "A"
    return "B" if all(len(c) == 1 for c in cards) else "C"


class ShardedInterpreter:
    """Packed inference over a DP x TP mesh.

    Args:
      model, layers: ModelSpec (or zoo name) and artifact layers.
      mesh: a ``parallel.Mesh``; else one of shape (dp, tp) over
        ``devices[:dp * tp]``, with ``dp`` all the devices ``tp`` leaves.
      devices: the slots' devices, every visible card by default (and with
        no card the call raises); may repeat a device.
      kernel, compute_dtype, domain: as ``packed_apply``'s (``domain`` is
        the port's: JAX's ``ShardedInterpreter`` runs the float domain).
      _split_at_slots: on the card, capture each data group as segments
        split at every copy between slots, on one card too (case C): the
        segment plan where no second card exists. Not a user option.

    On the card a call replays the compiled forward (``compile_s``,
    ``plan``); on ``cpu`` slots it runs ``sharded_apply`` eagerly. In case
    C each data group on distinct cards has NCCL communicators
    (``links``), made here and released with the interpreter.
    """

    def __init__(self, model, layers, mesh=None, dp=None, tp=1,
                 kernel="auto", compute_dtype=torch.bfloat16, devices=None,
                 domain="float", _split_at_slots=False):
        if isinstance(model, str):
            model = get_model(model)
        if not isinstance(model, ModelSpec):
            raise TypeError(f"model must be a ModelSpec or a zoo name, got "
                            f"{type(model).__name__}")
        self.spec = model
        if mesh is None:
            devices = list(devices) if devices is not None else (
                visible_cards())
            dp = dp or len(devices) // tp
            mesh = make_mesh((dp, tp), devices=devices[:dp * tp])
        self.mesh = mesh
        self.layers = shard_artifact(prepare_runtime_arrays(layers), mesh)
        self._groups = partition_layers(self.layers, mesh)
        self._kw = dict(kernel=kernel, compute_dtype=compute_dtype,
                        domain=domain)
        self.case = plan_case([g.devices for g in self._groups],
                              _split_at_slots)
        self._compiled = None
        # One set of NCCL communicators per tuple of cards that a group of
        # case C spans, made now, outside any capture.
        self.links = {}
        if self.case is not None:
            # The graphs hold the interpreter weakly, so that their memory
            # goes with it without waiting for the garbage collector.
            this = weakref.proxy(self)
            first = mesh.devices.flat[0]
            if self.case == "A":
                parts = [(lambda x: this._forward(x), first, [first])]
            else:
                parts = []
                for g in self._groups:
                    plan = "split_at_slots" if _split_at_slots else "segments"
                    # NCCL takes one rank per card: distinct cards only.
                    if (self.case == "C" and not _split_at_slots
                            and len(set(g.devices)) == len(g.devices)):
                        plan = "per_card"
                        key = tuple(g.devices)
                        if key not in self.links:
                            self.links[key] = NcclLinks(key)
                    parts.append((lambda x, g=g: this._group_forward(g, x),
                                  g.home, g.devices, plan))
            self._compiled = CompiledParts(parts, first)

    @property
    def data_parallelism(self):
        return self.mesh.shape["data"]

    def __call__(self, x):
        """Forward one global batch (array-like or tensor, on the host or a
        card); returns a fresh tensor on the mesh's first slot. On the card
        the first call at an input (shape, dtype) compiles (``compile_s``)
        and every call replays the compiled forward; inside
        ``kernels.debug_checks()`` it raises (run ``sharded_apply``
        there)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        x = x.to(torch.float32)
        if self._compiled is not None:
            return self._compiled(x)
        return self._forward(x)

    def _forward(self, x):
        """The whole sharded forward, eagerly: what case A compiles."""
        return sharded_apply(self.spec, self.layers, x, self.mesh,
                             groups=self._groups, **self._kw)

    def _group_forward(self, group, x, log=None):
        """One data group's forward, through its NCCL links where it has
        them: what cases B and C compile (``log`` receives its transfers
        between slots)."""
        return group_apply(self.spec, group, x, log=log,
                           links=self.links.get(tuple(group.devices)),
                           **self._kw)

    @property
    def compile_s(self):
        """Seconds of the first call at each input (shape, dtype) compiled
        so far; empty where nothing is compiled (``cpu`` slots)."""
        return {} if self._compiled is None else dict(self._compiled.compile_s)

    @property
    def plan(self):
        """What a call does on the card: the ``case`` ("A", "B", "C"; None
        on ``cpu`` slots), and by input (shape, dtype) compiled so far the
        ``graphs`` it replays and its ``host_steps`` (replays and copies)."""
        c = self._compiled
        return {"case": self.case,
                "graphs": {} if c is None else dict(c.graphs),
                "host_steps": {} if c is None else dict(c.host_steps)}

    def input_buffer(self, shape, dtype):
        """In case A, the compiled forward's static input at (``shape``,
        ``dtype``): a batch written there and passed to the call is not
        copied again. Fill it and call from one thread. None otherwise."""
        if self._compiled is None:
            return None
        return self._compiled.input_buffer(shape, dtype)


class MultiHostServer:
    """Continuous-batching server over a device mesh with health-driven
    re-sharding.

    Args:
      model, layers: model spec + converted artifact.
      host_devices: dict host_id -> list of devices; on host loss the mesh is
        rebuilt from surviving hosts' devices. Default: one "local" host with
        every visible card.
      batch_size: global batch per step (padded; sharded over "data").
    """

    def __init__(self, model, layers, host_devices=None, tp=1,
                 batch_size=32, max_delay_ms=5.0, heartbeat_timeout_s=5.0,
                 kernel="auto", compute_dtype=torch.bfloat16):
        self._model = model
        self._layers = layers
        self._tp = tp
        self._kernel = kernel
        self._dtype = compute_dtype
        self._lock = threading.Lock()
        if host_devices is None:
            host_devices = {"local": visible_cards()}
        self._host_devices = dict(host_devices)
        # True while every host has lapsed: the server keeps dispatching on
        # the last good mesh (calls may hang on real dead hardware), so
        # callers must be able to see the state and apply their own timeouts.
        self.degraded = False
        self.reshard_count = 0
        self._build(list(host_devices))
        self.monitor = HeartbeatMonitor(
            list(host_devices), timeout_s=heartbeat_timeout_s,
            on_loss=lambda h: self._reshard(),
            on_recovery=lambda h: self._reshard())
        self.engine = ServingEngine(self._infer, batch_size=batch_size,
                                    max_delay_ms=max_delay_ms)

    def _build(self, hosts):
        devices = [d for h in hosts for d in self._host_devices[h]]
        if not devices:
            raise RuntimeError("no live hosts remain")
        # Built outside the lock: a batch in flight keeps the old one.
        interp = ShardedInterpreter(
            self._model, self._layers, tp=min(self._tp, len(devices)),
            kernel=self._kernel, compute_dtype=self._dtype, devices=devices)
        with self._lock:
            self._interp = interp

    def _reshard(self):
        hosts = self.monitor.alive_hosts()
        if not hosts:
            # Total outage: keep serving on the last good mesh rather than
            # tearing the server down from the monitor thread; the next
            # recovery event rebuilds it. logging (not warnings.warn), so
            # that every recurrence is surfaced, not just the first.
            self.degraded = True
            logging.getLogger(__name__).warning(
                "all hosts lost heartbeat; serving degraded on previous mesh")
            return
        self._build(hosts)
        self.degraded = False
        self.reshard_count += 1

    def _infer(self, batch):
        with self._lock:
            interp = self._interp
        return interp(batch).cpu().numpy()

    def submit(self, image):
        return self.engine.submit(image)

    def predict(self, image, timeout=None):
        return self.engine.predict(image, timeout=timeout)

    def close(self):
        self.engine.close()
        self.monitor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
