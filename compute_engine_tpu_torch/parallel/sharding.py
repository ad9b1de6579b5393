"""Sharding specs for packed-model artifacts: the counterpart of
``compute_engine_tpu.parallel.sharding``.

TP layout: binary filters are packed as (O, FH, FW, Cpg) words, so sharding
axis 0 over the "model" mesh axis splits *output channels* across slots:
each slot computes a channel slice of every binary conv from the
(replicated, 32x-compressed) activations, and the slices are gathered where
the residual add, a concat or a float layer needs them
(``parallel.partition``). DP shards the batch over "data".

A spec is a tuple with one entry per dimension, an axis name or ``None``
(JAX's ``PartitionSpec``); ``()`` replicates. ``NamedSharding`` pairs a spec
with its mesh, and a ``ShardedTensor`` holds one tensor per slot of the
mesh, each on that slot's device: the counterpart of a ``jax.Array`` placed
with a ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["NamedSharding", "ShardedTensor", "artifact_shardings",
           "shard_artifact", "input_sharding", "device_put"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: tuple


def _layer_specs(layer):
    kind = layer["kind"]
    if kind == "bconv":
        return {
            "packed_filter": ("model", None, None, None),
            # pre-unpacked +-1 filter (prepare_runtime_arrays): HWIO layout,
            # same output-channel TP split on the last axis.
            "filter_pm1": (None, None, None, "model"),
            # zero padding's (O, 9) correction (prepare_runtime_arrays):
            # one row per output channel, split as the filter is.
            "tap_delta": ("model", None),
            "multiplier": ("model",),
            "bias": ("model",),
        }
    if kind == "conv":
        return {"kernel": (None, None, None, "model"), "bias": ("model",)}
    if kind == "depthwise_conv":
        return {"kernel": (None, None, "model", None), "bias": ("model",)}
    if kind == "dense":
        return {"kernel": (None, "model"), "bias": ("model",)}
    if kind == "bdense":
        return {"kernel_pm1": (None, "model"), "multiplier": ("model",),
                "bias": ("model",)}
    return {}


def _fit_spec(spec, shape, mesh):
    """Drop sharding on dims not divisible by their mesh-axis size (an
    uneven split is refused; replication is always valid)."""
    if spec is None:
        return ()
    fitted = []
    for i, axis in enumerate(spec):
        if axis is None:
            fitted.append(None)
            continue
        size = mesh.shape[axis]
        fitted.append(axis if i < len(shape) and shape[i] % size == 0
                      else None)
    return tuple(fitted)


def _is_array(v):
    return isinstance(v, (np.ndarray, torch.Tensor))


def artifact_shardings(layers, mesh):
    """Per-array NamedSharding tree matching the artifact layer dict."""
    out = {}
    for lname, layer in layers.items():
        specs = _layer_specs(layer)
        out[lname] = {
            k: NamedSharding(mesh, _fit_spec(specs.get(k), np.shape(v), mesh))
            for k, v in layer.items() if _is_array(v)
        }
    return out


class ShardedTensor:
    """One tensor per slot of ``mesh`` (row-major slot order), each on its
    slot's device: slot ``idx`` holds the block of the global tensor that
    its coordinates along the spec's axes select (the whole dimension where
    the spec has ``None``)."""

    def __init__(self, mesh, spec, shards, global_shape):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = list(shards)
        self.shape = tuple(global_shape)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{mesh.size} slots")

    def shard(self, idx) -> torch.Tensor:
        """The tensor of the slot at grid coordinate ``idx``."""
        return self.shards[int(np.ravel_multi_index(idx,
                                                    self.mesh.devices.shape))]

    def join(self, device=None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (the first slot's by
        default)."""
        device = self.mesh.devices.flat[0] if device is None else device
        names = self.mesh.axis_names
        # The slots whose coordinates are 0 on every axis the spec does not
        # name hold one block each; stitch their blocks dimension by
        # dimension.
        blocks = {}
        for idx, _ in self.mesh.slots():
            if any(idx[k] for k, a in enumerate(names) if a not in self.spec):
                continue
            key = tuple(idx[names.index(a)] if a is not None else 0
                        for a in self.spec)
            blocks[key] = self.shard(idx).to(device)
        return _stitch(blocks, [self.mesh.shape[a] if a is not None else 1
                                for a in self.spec])


def _stitch(blocks, counts):
    """Concatenate ``blocks`` (block coordinate -> tensor) along each
    dimension, innermost first."""
    if not counts:
        return blocks[()]
    *outer, last = counts
    dim = len(outer)
    merged = {}
    for key in {k[:-1] for k in blocks}:
        merged[key] = torch.cat([blocks[key + (j,)] for j in range(last)],
                                dim=dim)
    return _stitch(merged, outer)


def _block(t, idx, spec, mesh):
    """The block of ``t`` that slot ``idx`` holds under ``spec``."""
    names = mesh.axis_names
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        size = t.shape[dim] // n
        j = idx[names.index(axis)]
        t = t.narrow(dim, j * size, size)
    return t


def device_put(value, sharding: NamedSharding) -> ShardedTensor:
    """Place an array or tensor on ``sharding``'s mesh: every slot gets its
    block, contiguous, on its device. A dimension the spec names must be
    divisible by its axis (``_fit_spec`` replicates where it is not)."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    t = value if isinstance(value, torch.Tensor) else _tensor(value)
    for dim, axis in enumerate(spec):
        if axis is not None and t.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not "
                             f"divisible by mesh axis {axis!r} of size "
                             f"{mesh.shape[axis]}")
    shards = [_block(t, idx, spec, mesh).to(dev).contiguous()
              for idx, dev in mesh.slots()]
    return ShardedTensor(mesh, spec, shards, t.shape)


def _tensor(v):
    """A numpy array as a tensor (packed ``uint32`` words viewed as int32,
    as ``interop.layers_from_numpy`` does)."""
    v = np.array(v, order="C")
    if v.dtype == np.uint32:
        v = v.view(np.int32)
    return torch.from_numpy(v)


def shard_artifact(layers, mesh):
    """Place every artifact array with its TP sharding: each slot holds its
    block on its device (``ShardedTensor``); scalars and strings pass
    through."""
    shardings = artifact_shardings(layers, mesh)
    out = {}
    for lname, layer in layers.items():
        new = dict(layer)
        for k, sh in shardings[lname].items():
            new[k] = device_put(layer[k], sh)
        out[lname] = new
    return out


def input_sharding(mesh):
    """Batch (DP) sharding for NHWC image inputs."""
    return NamedSharding(mesh, ("data", None, None, None))
