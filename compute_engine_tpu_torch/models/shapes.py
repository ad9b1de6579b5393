"""Enumeration of a model's binary-layer shapes.

The port of ``compute_engine_tpu.models.shapes``. The selection table is
keyed by layer shape; ``binary_layer_shapes(spec, batch)`` traces a
ModelSpec's forward on ``torch.device("meta")`` with a recording builder (no
math runs and no parameter materialises, so the largest zoo models cost
nothing) and returns one record per binary conv and binary dense call, with
the GEMM row count ``m`` that keys the table. ``binary_layer_modes`` adds
the (domain, output kind) pairs under which the model runtime consults the
table for each layer; the planner (``kernels/autotune.py``), the coverage
test and the card's smoke run walk those. ``transition_layers`` names the
convs that a model's forward runs as dense-block transitions, whose filters
the model runtime prepares for the transition kernel.
"""

from __future__ import annotations

import torch

from ..core.params import BConv2DParams, tflite_same_padding
from ..core.types import Padding
from . import layers as L
from .builder import _Base, _joined_pair, _pair

__all__ = ["binary_layer_shapes", "binary_layer_modes", "transition_layers"]


class _ShapeRecorder(_Base):
    """Builder that records binary-layer shapes while shape-tracing.

    Weights are empty meta tensors; pooling and arithmetic come from the
    shared ``_Base``.
    """

    def __init__(self, batch):
        self.batch = batch
        self.binary_convs: list[dict] = []
        self.binary_denses: list[dict] = []

    @staticmethod
    def _weight(x, *shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    # -- float layers: only shapes matter -----------------------------------

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        kh, kw = _pair(ksize)
        w = self._weight(x, kh, kw, x.shape[-1] // groups, filters)
        return L.conv2d(x, w, _pair(stride), padding, groups=groups,
                        dilation=_pair(dilation))

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        kh, kw = _pair(ksize)
        w = self._weight(x, kh, kw, x.shape[-1], 1)
        return L.depthwise_conv2d(x, w, _pair(stride))

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        return L.dense(x, self._weight(x, x.shape[-1], units), None)

    # -- binary layers: record ----------------------------------------------

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        kh, kw = _pair(ksize)
        in_h, in_w, c_in = int(x.shape[1]), int(x.shape[2]), int(x.shape[-1])
        params = BConv2DParams(
            channels_in=c_in, stride=_pair(stride),
            padding=Padding.SAME if padding == "SAME" else Padding.VALID,
            pad_value=pad_value, groups=groups, dilation=_pair(dilation))
        out_h, out_w, _, _ = params.output_spatial(in_h, in_w, kh, kw)
        self.binary_convs.append({
            "name": name, "h": in_h, "w": in_w, "c_in": c_in,
            "c_out": int(filters), "fh": kh, "fw": kw,
            "stride": _pair(stride), "padding": padding,
            "pad_value": int(pad_value), "groups": groups,
            "dilation": _pair(dilation),
            "out_h": out_h, "out_w": out_w,
            "m": self.batch * out_h * out_w,
        })
        w = self._weight(x, kh, kw, c_in // groups, filters)
        if padding == "SAME" and pad_value == 1:
            _, pt, pb = tflite_same_padding(in_h, kh, _pair(stride)[0],
                                            _pair(dilation)[0])
            _, pl, pr = tflite_same_padding(in_w, kw, _pair(stride)[1],
                                            _pair(dilation)[1])
            x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=1.0)
            return L.conv2d(x, w, _pair(stride), "VALID", groups=groups,
                            dilation=_pair(dilation))
        return L.conv2d(x, w, _pair(stride), padding, groups=groups,
                        dilation=_pair(dilation))

    # The pair runs as the one conv that ``convert_model`` joins it into.
    binary_conv_pair = _joined_pair

    def rprelu(self, x, name):
        return x.clone()

    def binary_dense_bn(self, x, units, *, name):
        self.binary_denses.append({
            "name": name, "c_in": int(x.shape[-1]), "units": int(units),
            "m": self.batch,
        })
        return L.dense(x, self._weight(x, x.shape[-1], units), None)


def binary_layer_shapes(spec, batch=1):
    """Trace ``spec`` at the given batch and return its binary-layer shapes:
    ``(binary_convs, binary_denses)``, lists of per-call records (see
    ``_ShapeRecorder``)."""
    b = _ShapeRecorder(batch)
    x = torch.empty((batch, *spec.input_size, 3), dtype=torch.float32,
                    device="meta")
    spec.forward(b, x)
    return b.binary_convs, b.binary_denses


class _ReadRecorder(_ShapeRecorder):
    """A ``_ShapeRecorder`` that also records what reads each binary
    layer's output in the packed domain (``PackedBuilder(domain="packed")``):
    a binary layer reads bitpacked words, also through max pools and
    word-aligned flattens, which stay packed; every other consumer reads
    the float view."""

    def __init__(self, batch):
        super().__init__(batch)
        self.layers: list[tuple[str, dict]] = []  # (kind, record), in order
        self.reads: list[set[str]] = []

    def _read(self, x, out_kind):
        for t in x if isinstance(x, (list, tuple)) else (x,):
            src = getattr(t, "binary_layer", None)
            if src is not None:
                self.reads[src].add(out_kind)

    def _produced(self, y, kind, record):
        self.layers.append((kind, record))
        self.reads.append(set())
        y.binary_layer = len(self.layers) - 1
        return y

    def binary_conv_bn(self, x, filters, ksize, **kw):
        self._read(x, "bitpacked")
        y = super().binary_conv_bn(x, filters, ksize, **kw)
        return self._produced(y, "conv", self.binary_convs[-1])

    def binary_dense_bn(self, x, units, *, name):
        self._read(x, "bitpacked")
        y = super().binary_dense_bn(x, units, name=name)
        return self._produced(y, "dense", self.binary_denses[-1])

    def max_pool(self, x, *args, **kw):
        y = super().max_pool(x, *args, **kw)
        y.binary_layer = getattr(x, "binary_layer", None)
        return y

    def flatten(self, x):
        y = super().flatten(x)
        if x.shape[-1] % 32 == 0:
            y.binary_layer = getattr(x, "binary_layer", None)
        else:
            self._read(x, "float")
        return y


def _float_reader(method):
    base = getattr(_ShapeRecorder, method)

    def read(self, *args, **kw):
        for a in args:
            self._read(a, "float")
        return base(self, *args, **kw)

    return read


for _method in ("avg_pool", "global_avg_pool", "add", "concat", "add_tail",
                "add_repeated", "rprelu", "activation", "softmax", "conv_bn",
                "depthwise_conv_bn", "dense"):
    setattr(_ReadRecorder, _method, _float_reader(_method))


def binary_layer_modes(spec, batch=1):
    """Every consultation of the selection table that the model runtime
    makes for ``spec`` at ``batch``: (kind, record, domain, out_kind) with
    kind "conv" or "dense" and the record of ``binary_layer_shapes``.

    Every model runs in the float domain (float activations in, float out).
    A model with a packed-domain chain (some binary layer reads another's
    output) also runs in the packed domain, where every binary layer takes
    packed words in and writes what its readers take: bitpacked words for a
    binary layer, the float view for anything else, or both."""
    b = _ReadRecorder(batch)
    x = torch.empty((batch, *spec.input_size, 3), dtype=torch.float32,
                    device="meta")
    # ``packed_apply`` returns a binary layer's output as its packed words.
    b._read(spec.forward(b, x), "bitpacked")
    modes = [(kind, r, "float", "float") for kind, r in b.layers]
    if any("bitpacked" in reads for reads in b.reads):
        modes += [(kind, r, "packed", out_kind)
                  for (kind, r), reads in zip(b.layers, b.reads)
                  for out_kind in sorted(reads)]
    return modes


class _TransitionRecorder(_ShapeRecorder):
    """A ``_ShapeRecorder`` that records the name of each transition
    (``_Base.transition``) the forward makes."""

    def __init__(self, batch):
        super().__init__(batch)
        self.transitions: list[str] = []

    def transition(self, x, filters, *, name):
        self.transitions.append(name)
        return super().transition(x, filters, name=name)


def transition_layers(spec):
    """The names of the conv layers that ``spec``'s forward runs as
    dense-block transitions (a 1x1 conv and a 2x2/2 average pool, the
    builders' ``transition``), in forward order: none for a model without
    them."""
    b = _TransitionRecorder(1)
    x = torch.empty((1, *spec.input_size, 3), dtype=torch.float32,
                    device="meta")
    spec.forward(b, x)
    return b.transitions
