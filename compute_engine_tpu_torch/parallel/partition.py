"""The sharded forward: what GSPMD did for the JAX package.

JAX runs ``packed_apply`` under ``jit`` over weights placed with
``parallel.sharding``'s specs and lets XLA's partitioner insert the
collectives. The port has no partitioner, so this module does its work
explicitly, for the layout JAX's specs ask for:

* The batch is split over the mesh's "data" groups (``input_sharding``);
  each group runs its own forward.
* Within a group, activations are replicated (JAX's ``gather`` layout). One
  thread drives the group: the replicated layers run once, on the group's
  first slot (its home), and a layer the specs shard on "model" (``bconv``,
  ``conv``, ``depthwise_conv``, ``dense``, ``bdense``) runs on every model
  slot of the group, each on its channel slice, from the activation
  broadcast to it; the slices are then gathered on the home slot. A
  depthwise conv takes the matching input-channel slice.
* A layer runs replicated where its specs could not shard it (a dimension
  the axis does not divide, as ``_fit_spec`` replicates), where a slot's
  bitpacked output would not be whole 32-channel words, for a grouped float
  conv, and for every int8 layer of the true-int8 pipeline (an int8 conv,
  depthwise conv or dense, a binary conv with int8 output or input, the
  int8 ADD).

The per-slot work is the unsharded runtime's own (``models.PackedBuilder``
over the slot's arrays), so every lowering, kernel and launch count is the
one ``kernels.select`` gives at the shard's shape. A fused residual block
becomes, per slot, the block kernel without the add (its ``c_out`` is a
slice of ``c``), then the gather and the add: bit for bit the fused kernel,
which also rounds the conv to the activation type before it adds.

Weights: each slot holds its own block of every array the specs shard
(``shard_artifact``), as GSPMD's layout gives each device 1/tp of them. The
home slot assembles a sharded array whole only when a layer reads it to run
replicated (``_HomeLayer``), so a layer that runs sharded never costs the
home slot its whole weights.

How the slots exchange activations: by default a gather is a copy of each
slot's slice onto the home slot and a ``torch.cat`` there, and a broadcast
a copy from the home slot (``collective.to_slot``, ``all_gather``). Where a
group's slots lie on distinct cards, ``links`` (``collective.NcclLinks``)
joins them by NCCL instead, as GSPMD's program all-gathers on the device:
the all-gather leaves the whole activation on every slot, so a sharded
layer that follows reads it where it lies and no broadcast follows a
gather; what a replicated layer makes on the home slot reaches the model
slots by one NCCL broadcast. Every slot's copy is the same bytes, so the
forward is bit for bit the copies' forward. Every transfer between slots
is recorded in ``log`` when one is passed, by ``collective.record``:
"broadcast" (an activation to a model slot), "all_gather" (a slice to
another slot: to the home slot by copies, to every slot by NCCL).

The forward of one data group (``group_apply``) is the unit that the
compiled sharded forward captures; ``sharded_apply`` is the loop over the
groups and the concatenation of their outputs. Nothing in a group's forward
reads a value on the host, and a sharded array that a replicated layer
reads is joined on the home slot at its first read, so that a forward after
the first makes no copy of weights.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from ..kernels.bgemm import bgemm
from ..kernels.residual import binary_residual_block
from ..models.builder import (Int8Tensor, PackedBuilder, _Base,
                              _BinaryStream, _float_view, _forward_scope,
                              _result)
from .collective import all_gather, record, to_slot
from .sharding import ShardedTensor

__all__ = ["sharded_apply", "group_apply", "partition_layers",
           "ShardedBuilder", "shards_layer"]

# The array whose spec decides whether a layer of each kind is sharded.
_SHARD_KEY = {"bconv": "packed_filter", "conv": "kernel",
              "depthwise_conv": "kernel", "dense": "kernel",
              "bdense": "multiplier"}
# Per-output-channel arrays that the specs replicate and that a slot slices
# from its replica (axis 0) when the layer is sharded: the packed domain's
# sign-flipped filters and thresholds, the GEMM's packed dense kernel.
_LOCAL_SLICES = {"bconv": ("packed_filter_flipped", "thresholds"),
                 "bdense": ("packed_kernel", "packed_kernel_flipped",
                            "thresholds")}


def shards_layer(c_out: int, tp: int, out_kind: str = "float") -> bool:
    """Whether a layer of ``c_out`` output channels runs sharded over ``tp``
    model slots: the axis divides it and, for bitpacked output, each slot
    writes whole 32-channel words."""
    if tp == 1 or c_out % tp:
        return False
    return out_kind != "bitpacked" or (c_out // tp) % 32 == 0


class _HomeLayer(Mapping):
    """A layer's arrays on its group's home slot, read by a replicated run:
    a replicated array is the home slot's own; an array the specs shard on
    "model" is joined whole on the home slot the first time it is read and
    kept. Key presence is answered from the layer without joining."""

    def __init__(self, layer, home, coord):
        self._layer = layer
        self._home = home
        self._coord = coord
        self.joined = {}

    def __getitem__(self, k):
        v = self._layer[k]
        if not isinstance(v, ShardedTensor):
            return v
        if not _names_model(v) or v.mesh.shape["model"] == 1:
            return v.shard(self._coord)  # the home slot's block is whole
        if k not in self.joined:
            self.joined[k] = v.join(self._home)
        return self.joined[k]

    def __contains__(self, k):
        return k in self._layer

    def __iter__(self):
        return iter(self._layer)

    def __len__(self):
        return len(self._layer)


class _Group:
    """One "data" group of the mesh: its home slot, its model slots, the
    layers as the home slot reads them to run replicated, and each model
    slot's own layers."""

    def __init__(self, sharded_layers, mesh, d):
        tp = mesh.shape.get("model", 1)
        self.mesh = mesh
        self.coords = [(d, j) for j in range(tp)]
        self.devices = [mesh.devices[c] for c in self.coords]
        self.home = self.devices[0]
        self.sharded = {}
        self.layers = {}
        self.slot_layers = [{} for _ in range(tp)]
        for name, layer in sharded_layers.items():
            key = _SHARD_KEY.get(layer.get("kind"))
            self.sharded[name] = tp > 1 and _names_model(layer.get(key))
            self.layers[name] = _HomeLayer(layer, self.home, self.coords[0])
            if not self.sharded[name]:
                continue
            local = _LOCAL_SLICES.get(layer["kind"], ())
            for j, c in enumerate(self.coords):
                slot = {}
                for k, v in layer.items():
                    if not isinstance(v, ShardedTensor):
                        slot[k] = v
                    elif k in local and not _names_model(v):
                        per = v.shape[0] // tp
                        slot[k] = v.shard(c)[j * per:(j + 1) * per]
                    else:
                        slot[k] = v.shard(c)
                self.slot_layers[j][name] = slot

    def joined(self):
        """The whole arrays the home slot has assembled so far, by layer:
        only those of layers that ran replicated."""
        return {name: dict(a.joined) for name, a in self.layers.items()
                if a.joined}


def _names_model(v):
    return isinstance(v, ShardedTensor) and "model" in v.spec


def partition_layers(sharded_layers, mesh):
    """The per-group views of ``shard_artifact``'s layers that
    ``sharded_apply`` runs on; build them once and pass them as
    ``groups=`` to run many batches."""
    return [_Group(sharded_layers, mesh, d)
            for d in range(mesh.shape.get("data", 1))]


class ShardedBuilder(PackedBuilder):
    """``PackedBuilder`` of one data group: replicated layers run on the
    home slot, sharded layers on every model slot (a ``PackedBuilder`` each,
    over the slot's arrays), gathered on the home slot, by copies or by
    ``links`` (see the module docstring)."""

    def __init__(self, group: _Group, log=None, links=None, **kw):
        super().__init__(group.layers, **kw)
        self.group = group
        self.log = log
        self.links = links
        # The last activation that every slot holds: (the home slot's
        # tensor, each slot's copy), from an all-gather or a broadcast.
        self._replicas = None
        self.slots = [PackedBuilder(layers, **kw)
                      for layers in group.slot_layers]

    @property
    def tp(self):
        return len(self.slots)

    def dense_block(self, x, width):
        """A dense block's stream stays as it is: its layers' outputs are
        gathered from the slots and concatenated by copies."""
        return x

    # A transition's conv may be sharded: it runs by ``conv_bn``, then the
    # pool, as the two layers they are.
    transition = _Base.transition

    # -- copies between slots ------------------------------------------------

    def _broadcast(self, t, j):
        """The replicated activation ``t`` on model slot ``j``."""
        g = self.group
        if self.links is None:
            return to_slot(t, g.coords[0], g.coords[j], g.mesh, self.log)
        if j == 0:
            return t
        if self._replicas is None or self._replicas[0] is not t:
            for c in g.coords[1:]:
                record(self.log, "broadcast", [t], g.coords[0], c, g.mesh)
            self._replicas = (t, self.links.broadcast(t))
        return self._replicas[1][j]

    def _gather(self, pieces):
        """The slots' channel slices, concatenated on the home slot (by
        ``links`` on every slot, kept for the next broadcast)."""
        g = self.group
        if self.links is None:
            return all_gather(pieces, g.coords, g.coords[0], g.mesh, self.log)
        for src, p in zip(g.coords, pieces):
            for dst in g.coords:
                if dst != src:
                    record(self.log, "all_gather", [p], src, dst, g.mesh)
        full = self.links.all_gather(pieces)
        self._replicas = (full[0], full)
        return full[0]

    def _channel_slice(self, xf, j):
        """Slot ``j``'s slice of the replicated activation's channels."""
        per = xf.shape[-1] // self.tp
        if self.links is None:
            return self._broadcast(
                xf[..., j * per:(j + 1) * per].contiguous(), j)
        return self._broadcast(xf, j)[..., j * per:(j + 1) * per].contiguous()

    def _slot_input(self, x, j):
        """A binary layer's input on slot ``j``: a packed stream stays lazy
        (words or float view, whichever the slot's layer pulls)."""
        if isinstance(x, _BinaryStream):
            return _BinaryStream(lambda: self._broadcast(x.packed(), j),
                                 lambda: self._broadcast(x.to_float(), j),
                                 x.channels)
        return self._broadcast(_float_view(x), j)

    # -- layers --------------------------------------------------------------

    def conv_bn(self, x, filters, ksize, *, groups=1, name, **kw):
        if (not self.group.sharded[name] or groups != 1
                or isinstance(x, Int8Tensor)):
            return super().conv_bn(x, filters, ksize, groups=groups,
                                   name=name, **kw)
        xf = _float_view(x)
        return self._gather([
            _float_view(sb.conv_bn(self._broadcast(xf, j), filters // self.tp,
                                   ksize, groups=1, name=name, **kw))
            for j, sb in enumerate(self.slots)])

    def depthwise_conv_bn(self, x, ksize, *, name, **kw):
        if not self.group.sharded[name] or isinstance(x, Int8Tensor):
            return super().depthwise_conv_bn(x, ksize, name=name, **kw)
        xf = _float_view(x)
        return self._gather([
            sb.depthwise_conv_bn(self._channel_slice(xf, j), ksize, name=name,
                                 **kw)
            for j, sb in enumerate(self.slots)])

    def dense(self, x, units, *, name, **kw):
        if not self.group.sharded[name] or isinstance(x, Int8Tensor):
            return super().dense(x, units, name=name, **kw)
        xf = _float_view(x)
        return self._gather([
            sb.dense(self._broadcast(xf, j), units // self.tp, name=name,
                     **kw)
            for j, sb in enumerate(self.slots)])

    def _sharded_binary(self, x, channels, run_slot, run_home, packed):
        """A binary layer over the model slots: ``run_slot(j, x_j)`` is slot
        j's layer call, ``run_home()`` the replicated one. In the packed
        domain the result is a lazy stream whose words are gathered only
        where each slot's are whole words."""
        if not packed:
            return self._gather([
                _float_view(run_slot(j, self._slot_input(x, j)))
                for j in range(self.tp)])
        streams = [run_slot(j, self._slot_input(x, j))
                   for j in range(self.tp)]

        def words():
            if shards_layer(channels, self.tp, "bitpacked"):
                return self._gather([s.packed() for s in streams])
            return run_home().packed()

        return _BinaryStream(
            words, lambda: self._gather([s.to_float() for s in streams]),
            channels)

    def binary_conv_bn(self, x, filters, ksize, *, name, **kw):
        a = self.layers[name]
        if (not self.group.sharded[name] or "out_scale" in a
                or int(a.get("groups", 1)) != 1 or isinstance(x, Int8Tensor)):
            return super().binary_conv_bn(x, filters, ksize, name=name, **kw)
        packed = self.domain == "packed" and "thresholds" in a
        return self._sharded_binary(
            x, filters,
            lambda j, xj: self.slots[j].binary_conv_bn(
                xj, filters // self.tp, ksize, name=name, **kw),
            lambda: super(ShardedBuilder, self).binary_conv_bn(
                x, filters, ksize, name=name, **kw),
            packed)

    def binary_dense_bn(self, x, units, *, name):
        a = self.layers[name]
        if not self.group.sharded[name] or isinstance(x, Int8Tensor):
            return super().binary_dense_bn(x, units, name=name)
        packed = self.domain == "packed" and "thresholds" in a
        return self._sharded_binary(
            x, units,
            lambda j, xj: self.slots[j].binary_dense_bn(
                xj, units // self.tp, name=name),
            lambda: super(ShardedBuilder, self).binary_dense_bn(
                x, units, name=name),
            packed)


def group_apply(spec, group, x, kernel="auto", compute_dtype=torch.bfloat16,
                residual_block=binary_residual_block, gemm=bgemm,
                domain="float", log=None, links=None):
    """The forward of one data ``group`` (``partition_layers``) on ``x``,
    its share of the batch on the group's home slot; returns the output
    there. ``links`` (``collective.NcclLinks`` over the group's cards)
    joins the slots in place of copies; the other arguments are
    ``sharded_apply``'s."""
    with _forward_scope(compute_dtype):
        builder = ShardedBuilder(
            group, log=log, links=links, kernel=kernel,
            compute_dtype=compute_dtype, residual_block=residual_block,
            gemm=gemm, domain=domain)
        return _result(spec.forward(builder, x))


def sharded_apply(spec, sharded_layers, x, mesh, kernel="auto",
                  compute_dtype=torch.bfloat16,
                  residual_block=binary_residual_block, gemm=bgemm,
                  domain="float", groups=None, log=None):
    """``packed_apply`` over ``mesh``: ``sharded_layers`` come from
    ``shard_artifact`` (of ``prepare_runtime_arrays``'d layers), ``x`` is
    the global batch, split over the "data" groups (its size must be a
    multiple of theirs). Returns the output on the mesh's first slot.

    ``groups`` (``partition_layers``) saves assembling the per-group views
    again; ``log`` receives the copies between slots. The other arguments
    are ``packed_apply``'s.
    """
    groups = groups if groups is not None else partition_layers(
        sharded_layers, mesh)
    dp = len(groups)
    x = torch.as_tensor(x)
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's "
                         f"data axis of size {dp}")
    per = x.shape[0] // dp
    with _forward_scope(compute_dtype):
        outs = [group_apply(spec, group,
                            x[d * per:(d + 1) * per].to(group.home,
                                                        non_blocking=True),
                            kernel, compute_dtype, residual_block, gemm,
                            domain, log)
                for d, group in enumerate(groups)]
        first = groups[0].home
        return torch.cat([o.to(first, non_blocking=True) for o in outs])
