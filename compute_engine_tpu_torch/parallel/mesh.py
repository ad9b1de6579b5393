"""Device-mesh construction: the counterpart of
``compute_engine_tpu.parallel.mesh``.

JAX's mesh is single-controller: one process holds a grid of devices and
XLA inserts the collectives. The port keeps that model. A ``Mesh`` is a grid
of ``torch.device`` slots driven by one process; a collective is an explicit
copy between slots (``parallel.collective``, ``parallel.partition``), which
goes peer to peer over NVLink between two cards of a host. Only
``runtime.multiprocess`` uses ``torch.distributed``, as JAX's counterpart
uses ``jax.distributed``.

A slot is a position in the grid, and a list of devices may repeat a device:
eight ``cpu`` slots stand for JAX's eight virtual CPU devices, and
``cuda:0`` four times runs a four-slot mesh on one card. A copy between two
slots of one device is then a local copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "visible_cards", "device_slots"]


def visible_cards() -> list[torch.device]:
    """Every visible card, ``cuda:0 .. cuda:n-1``; raises without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_slots(n, device="cuda"):
    """``n`` device slots for a mesh and a label saying which: distinct
    cards where the visible ones cover them, else the first card (or the
    CPU) ``n`` times."""
    device = resolve_device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n:
            return ([torch.device("cuda", i) for i in range(n)],
                    f"{n} card{'s' if n > 1 else ''}")
        return [torch.device("cuda", 0)] * n, f"cuda:0 x {n}"
    return [device] * n, f"{device} x {n}"


class Mesh:
    """A grid of device slots with named axes.

    ``devices`` is a numpy object array of ``torch.device`` (so
    ``.devices.size`` and ``.devices.ravel()`` work as on a JAX mesh),
    ``axis_names`` its axes' names and ``shape`` maps each name to its size.
    Entering the mesh as a context does nothing; it is there so that code
    written for JAX's ``with mesh:`` reads the same.
    """

    def __init__(self, devices: np.ndarray, axis_names):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of rank {devices.ndim} needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def slots(self) -> list[tuple[tuple[int, ...], torch.device]]:
        """(grid coordinate, device) of every slot, in row-major order."""
        return [(idx, self.devices[idx]) for idx in np.ndindex(
            self.devices.shape)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def make_mesh(shape=None, axis_names=("data", "model"), devices=None):
    """Create a Mesh over ``devices``, every visible card by default.

    Args:
      shape: (data, model) sizes; default (n_devices, 1). The "data" axis
        shards the image batch (DP); "model" shards binary-conv output
        channels (TP).
      devices: a list of devices (``torch.device`` or strings) that may
        repeat one; default every visible card, and without a card the call
        raises.
    """
    if devices is None:
        devices = visible_cards()
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda":
            resolve_device(d)
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)
