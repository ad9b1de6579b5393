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
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..models import get_model, prepare_runtime_arrays
from ..models.zoo import ModelSpec
from ..parallel import make_mesh, shard_artifact
from ..parallel.mesh import visible_cards
from ..parallel.partition import partition_layers, sharded_apply
from .health import HeartbeatMonitor
from .serving import ServingEngine

__all__ = ["ShardedInterpreter", "MultiHostServer"]


class ShardedInterpreter:
    """Packed inference over a DP x TP mesh.

    Args:
      model, layers: ModelSpec (or zoo name) and artifact layers.
      mesh: a ``parallel.Mesh``; else one of shape (dp, tp) over
        ``devices[:dp * tp]``, with ``dp`` all the devices ``tp`` leaves.
      devices: the slots' devices, every visible card by default (and with
        no card the call raises); may repeat a device.
      kernel, compute_dtype: as ``packed_apply``'s.
    """

    def __init__(self, model, layers, mesh=None, dp=None, tp=1,
                 kernel="auto", compute_dtype=torch.bfloat16, devices=None):
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
        self._kw = dict(kernel=kernel, compute_dtype=compute_dtype)

    @property
    def data_parallelism(self):
        return self.mesh.shape["data"]

    def __call__(self, x):
        """Forward one global batch (array-like or tensor); returns a tensor
        on the mesh's first slot."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        return sharded_apply(self.spec, self.layers, x.to(torch.float32),
                             self.mesh, groups=self._groups, **self._kw)


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
