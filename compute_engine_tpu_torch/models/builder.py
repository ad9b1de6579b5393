"""Model builders: one architecture definition, several execution modes.

The port of ``compute_engine_tpu.models.builder``:

  InitBuilder       creates the float parameter tree (Keras layouts) from a
                    numpy seed, calling the rng in the same order as the JAX
                    package, so both give the same weights bit for bit
  FloatBuilder      QAT-style float forward (``ste_sign`` fake-quant): the
                    semantic oracle
  CalibrateBuilder  the float forward, recording the abs-max range of every
                    quantisable layer's input and output
  ConvertBuilder    emits the packed inference artifact (BN folding, sign
                    binarisation, bitpacking; with calibrated ranges also
                    int8 weights, scales and int8 output transforms) as numpy
                    arrays, identical to the JAX package's
  PackedBuilder     packed inference forward, in the float domain or, for
                    chains of binary layers, in the packed domain; layers
                    converted with ranges run in int8 and exchange
                    ``Int8Tensor``s (the true-int8 pipeline)

Init and Convert trace shapes on ``torch.device("meta")`` (the counterpart of
``jax.eval_shape``): no activation math runs, only the host-side numpy
weight transformation.

Parameter trees map layer names to dicts of float32 CPU tensors; artifact
layers are numpy (``uint32`` packed words) as on disk; the runtime layers
that PackedBuilder reads are tensors on the run's device
(``interop.layers_from_numpy``).
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch

from ..core.bitpack import bitpack_np, bitunpack
from ..core.params import BConv2DParams, tflite_same_padding
from ..core.reference import zero_padding_tap_delta
from ..core.transforms import (OutputTransform, compute_output_thresholds,
                               fuse_output_transform)
from ..core.types import Activation, Padding, round_half_away
from ..device import exact_float32, resolve_device
from ..interop import layers_from_numpy
from ..kernels import counts
from ..kernels import stem as _stem
from ..kernels import transition as _transition
from ..kernels.bconv2d import (bconv2d_mxu_float_in, bconv2d_mxu_s2d,
                               bdense_mxu, bdense_mxu_float_in)
from ..kernels.bgemm import bgemm
from ..kernels.residual import binary_residual_block, rprelu_plain
from ..kernels.select import layer_lowering
from ..ops import bconv2d, bmaxpool2d, quantize
from . import layers as L

__all__ = ["InitBuilder", "FloatBuilder", "CalibrateBuilder",
           "ConvertBuilder", "PackedBuilder", "Int8Tensor", "init_model",
           "float_apply", "calibrate_model", "convert_model",
           "packed_apply", "prepare_runtime_arrays", "concat", "add_tail",
           "rprelu", "KERNELS"]

# The ``kernel=`` values of PackedBuilder and the entry points above it.
KERNELS = ("auto", "reference", "bgemm", "mxu", "s2d", "residual")


class _Base:
    """Shared pooling/arithmetic ops (identical in every mode)."""

    def max_pool(self, x, pool_size, stride=None, padding="SAME"):
        pool_size = _pair(pool_size)
        stride = _pair(stride) if stride is not None else pool_size
        return L.max_pool(x, pool_size, stride, padding)

    def avg_pool(self, x, pool_size, stride=None, padding="VALID"):
        pool_size = _pair(pool_size)
        stride = _pair(stride) if stride is not None else pool_size
        return L.avg_pool(x, pool_size, stride, padding)

    def global_avg_pool(self, x):
        return L.global_avg_pool(x)

    def add(self, a, b):
        return a + b

    def concat(self, xs):
        return torch.cat(xs, dim=-1)

    def add_tail(self, x, y):
        """``y`` added into the last ``y.shape[-1]`` channels of ``x``
        (MeliusNet's improvement block), the channels before them as they
        are."""
        return _add_into_tail(x, y)

    def add_repeated(self, y, r):
        """``r`` added to each of ``y``'s equal parts along its channels,
        ``y`` as wide as a whole number of ``r``'s (ReActNet's doubling
        block adds its input to both convs of the pair), with nothing
        copied to repeat ``r``."""
        return _add_repeated(y, r)

    def binary_conv_pair(self, x, filters, *, names):
        """ReActNet's doubling 1x1 pair: two binary 1x1 VALID convs of one
        input, each ``filters`` wide, with one input shift, side by side on
        the channel axis (the layers ``names``, in order; each holds the
        shift, the same values). Here the two convs and a concatenation, as
        published; ``convert_model`` joins their layers into one conv of
        twice the width under the first name, which the packed forward
        runs."""
        return self.concat([
            self.binary_conv_bn(x, filters, 1, padding="VALID",
                                input_shift=True, name=name)
            for name in names])

    def rprelu(self, x, name):
        """ReActNet's RPReLU of ``x``, with the vectors that the layer
        ``name``'s entry holds (``_rprelu_vectors``), by the plain chain
        (``kernels.residual.rprelu_plain``); the packed forward runs it in a
        block kernel's epilogue where it can."""
        return rprelu_plain(x, *(v.to(x.device) for v in
                                 self._rprelu_vectors(name, x.shape[-1])))

    def dense_block(self, x, width):
        """The stream ``x`` entering a dense block whose concatenations
        grow it to ``width`` channels. Only the packed forward makes use of
        the width; here the stream is returned as it is."""
        return x

    def transition(self, x, filters, *, name):
        """A dense block's float transition: a 1x1 conv with BN to
        ``filters`` channels (the layer ``name``), then a 2x2/2 VALID
        average pool. Here the two layers as they are; the packed forward
        runs them as one kernel where it can."""
        return self.avg_pool(self.conv_bn(x, filters, 1, name=name), 2, 2)

    def flatten(self, x):
        return x.reshape(x.shape[0], -1)

    def activation(self, x, kind):
        return L.apply_activation(x, kind)

    def softmax(self, x):
        return torch.softmax(x.to(torch.float32), dim=-1)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _add_into_tail(x, y):
    k = y.shape[-1]
    return torch.cat([x[..., :-k], x[..., -k:] + y], dim=-1)


def _add_repeated(y, r):
    c = r.shape[-1]
    if y.shape[-1] % c:
        raise ValueError(f"{y.shape[-1]} channels are no whole number of "
                         f"{c}")
    return (y.unflatten(-1, (-1, c)) + r.unsqueeze(-2)).flatten(-2)


def _joined_pair(builder, x, filters, *, names):
    """``binary_conv_pair`` as ``convert_model`` leaves it: one conv of
    twice the width, under the first name."""
    return builder.binary_conv_bn(x, 2 * filters, 1, padding="VALID",
                                  input_shift=True, name=names[0])


def _rprelu_params(p, channels):
    """The ``(shift_in, slope, shift_out)`` of a parameter-tree entry's
    RPReLU, checked against the channels it acts on."""
    r = p["rprelu"]
    vectors = tuple(torch.as_tensor(r[k]) for k in RPRELU_KEYS)
    shapes = [tuple(v.shape) for v in vectors]
    if any(shape != (channels,) for shape in shapes):
        raise ValueError(f"RPReLU vectors of {shapes} for {channels} "
                         "channels")
    return vectors


# The keys of an RPReLU in a parameter-tree entry (``p["rprelu"]``); a
# converted layer holds them as ``rprelu_<key>``.
RPRELU_KEYS = ("shift_in", "slope", "shift_out")


def _on(tree, like):
    """Tensors of a (nested) dict moved to ``like``'s device."""
    return {k: torch.as_tensor(v).to(like.device) for k, v in tree.items()}


def _float_binary_conv(x, kernel, stride, padding, pad_value, groups=1,
                       dilation=(1, 1)):
    """QAT forward sign(x) conv sign(w): one-padding pads +1 after the
    sign, zero-padding pads the literal 0.0."""
    xq = L.ste_sign(x)
    wq = L.ste_sign(kernel)
    if padding == "SAME" and pad_value == 1:
        kh, kw = kernel.shape[0], kernel.shape[1]
        _, pt, pb = tflite_same_padding(x.shape[1], kh, stride[0],
                                        dilation[0])
        _, pl, pr = tflite_same_padding(x.shape[2], kw, stride[1],
                                        dilation[1])
        xq = torch.nn.functional.pad(xq, (0, 0, pl, pr, pt, pb), value=1.0)
        return L.conv2d(xq, wq, stride, "VALID", groups=groups,
                        dilation=dilation)
    return L.conv2d(xq, wq, stride, padding, groups=groups, dilation=dilation)


def _float_binary_dense(x, kernel):
    """QAT binary dense: sign(x) @ sign(w)."""
    return L.dense(L.ste_sign(x), L.ste_sign(kernel))


class InitBuilder(_Base):
    """Creates the float parameter tree while tracing the forward."""

    def __init__(self, seed=0, randomize_bn=False):
        self.rng = np.random.default_rng(seed)
        self.params = {}
        self.randomize_bn = randomize_bn

    def _new(self, name, kernel, bn):
        self.params[name] = {
            "kernel": torch.from_numpy(kernel),
            "bn": {k: torch.from_numpy(v) for k, v in bn.items()}}
        return self.params[name]

    def _bn(self, c):
        return L.init_bn(self.rng, c, randomize=self.randomize_bn)

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        kh, kw = _pair(ksize)
        c = x.shape[-1] // groups
        kernel = L.he_normal(self.rng, (kh, kw, c, filters), kh * kw * c)
        p = self._new(name, kernel, self._bn(filters))
        return L.batch_norm(
            L.conv2d(x, p["kernel"], _pair(stride), padding, groups=groups,
                     dilation=_pair(dilation)), _on(p["bn"], x))

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        kh, kw = _pair(ksize)
        c = x.shape[-1]
        kernel = L.he_normal(self.rng, (kh, kw, c, 1), kh * kw)
        p = self._new(name, kernel, self._bn(c))
        return L.batch_norm(
            L.depthwise_conv2d(x, p["kernel"], _pair(stride)),
            _on(p["bn"], x))

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        kh, kw = _pair(ksize)
        c = x.shape[-1] // groups
        # Latent real-valued weights, binarised by ste_sign at use.
        kernel = self.rng.uniform(-1, 1,
                                  (kh, kw, c, filters)).astype(np.float32)
        p = self._new(name, kernel, self._bn(filters))
        if input_shift:
            # ReActNet's learnable bias before the sign: zeros, as it is
            # initialised, or drawn where the BN statistics are.
            p["shift"] = torch.from_numpy(self._vector(x.shape[-1], 0.0, 0.2))
            x = x + p["shift"].to(x.device)
        return L.batch_norm(
            _float_binary_conv(x, p["kernel"].to(x.device), _pair(stride),
                               padding, pad_value, groups=groups,
                               dilation=_pair(dilation)), _on(p["bn"], x))

    def binary_conv_pair(self, x, filters, *, names):
        # The pair's one shift is the first conv's, under both names.
        first, second = names
        y = self.binary_conv_bn(x, filters, 1, padding="VALID",
                                input_shift=True, name=first)
        shift = self.params[first]["shift"]
        z = self.binary_conv_bn(x + shift.to(x.device), filters, 1,
                                padding="VALID", name=second)
        self.params[second]["shift"] = shift
        return self.concat([y, z])

    def _vector(self, c, mean, spread):
        """``c`` float32 values: ``mean`` everywhere, or where the BN
        statistics are drawn, drawn about it by ``spread``."""
        if not self.randomize_bn:
            return np.full(c, mean, np.float32)
        return (mean + spread * self.rng.standard_normal(c)).astype(
            np.float32)

    def _rprelu_vectors(self, name, c):
        """Creates the RPReLU of ``c`` channels in the layer ``name``'s
        entry: zero shifts and slope 0.25 (PyTorch's PReLU), as ReActNet
        initialises it, or drawn where the BN statistics are."""
        slope = (np.full(c, 0.25, np.float32) if not self.randomize_bn
                 else self.rng.uniform(0.05, 0.5, c).astype(np.float32))
        self.params[name]["rprelu"] = {
            "shift_in": torch.from_numpy(self._vector(c, 0.0, 0.2)),
            "slope": torch.from_numpy(slope),
            "shift_out": torch.from_numpy(self._vector(c, 0.0, 0.2))}
        return _rprelu_params(self.params[name], c)

    def binary_dense_bn(self, x, units, *, name):
        c = x.shape[-1]
        kernel = self.rng.uniform(-1, 1, (c, units)).astype(np.float32)
        p = self._new(name, kernel, self._bn(units))
        return L.batch_norm(
            _float_binary_dense(x, p["kernel"].to(x.device)), _on(p["bn"], x))

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        c = x.shape[-1]
        kernel = L.glorot_uniform(self.rng, (c, units), c, units)
        p = {"kernel": torch.from_numpy(kernel)}
        if use_bias:
            p["bias"] = torch.zeros(units, dtype=torch.float32)
        self.params[name] = p
        y = L.dense(x, p["kernel"],
                    p["bias"].to(x.device) if use_bias else None)
        return L.apply_activation(y, activation)


class FloatBuilder(_Base):
    """QAT-style float forward from a parameter tree (the accuracy oracle).

    ``operand_dtype`` (``None``: float32) rounds the operands of the float
    convs and dense layers to that dtype before a float32 product; the
    binary layers' operands are +-1 and exact in any dtype."""

    def __init__(self, params, operand_dtype=None):
        self.params = params
        self.operand_dtype = operand_dtype

    def _operand(self, x):
        return x if self.operand_dtype is None else x.to(self.operand_dtype)

    def _kernel(self, name, x):
        return torch.as_tensor(self.params[name]["kernel"]).to(x.device)

    def _apply_bn(self, y, name):
        """BN application hook: inference-mode moving statistics here; a
        training builder overrides it with batch statistics."""
        return L.batch_norm(y, _on(self.params[name]["bn"], y))

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        y = L.conv2d(self._operand(x), self._kernel(name, x), _pair(stride),
                     padding, groups=groups, dilation=_pair(dilation))
        return L.apply_activation(self._apply_bn(y, name), activation)

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        y = L.depthwise_conv2d(self._operand(x), self._kernel(name, x),
                               _pair(stride))
        return L.apply_activation(self._apply_bn(y, name), activation)

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        if input_shift:
            x = x + torch.as_tensor(self.params[name]["shift"]).to(x.device)
        y = _float_binary_conv(x, self._kernel(name, x), _pair(stride),
                               padding, pad_value, groups=groups,
                               dilation=_pair(dilation))
        return self._apply_bn(y, name)

    def _rprelu_vectors(self, name, c):
        return _rprelu_params(self.params[name], c)

    def binary_dense_bn(self, x, units, *, name):
        return self._apply_bn(
            _float_binary_dense(x, self._kernel(name, x)), name)

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        p = self.params[name]
        y = L.dense(self._operand(x), self._kernel(name, x),
                    torch.as_tensor(p["bias"]).to(x.device)
                    if use_bias else None)
        return L.apply_activation(y, activation)


class CalibrateBuilder(FloatBuilder):
    """Float forward that records per-layer input/output abs-max ranges.

    The activation-range calibration pass of int8 conversion. Run it over a
    few batches, then pass ``ranges`` to ``convert_model(...,
    int8_ranges=)``; pass ``out_ranges`` as ``int8_out_ranges=`` to keep int8
    tensors flowing between consecutive int8 layers (the true-int8 pipeline)
    instead of rescaling to float after every layer.
    """

    def __init__(self, params, ranges=None):
        super().__init__(params)
        self.ranges = ranges if ranges is not None else {}
        self.out_ranges = {}
        self._add_idx = 0

    def _record(self, name, x, table):
        table[name] = max(table.get(name, 0.0), float(x.abs().max()))

    def add(self, a, b):
        # Residual adds get names by trace order (the forward is
        # deterministic, so every builder sees the same sequence). An add
        # with a calibrated output range becomes an int8 ADD in the converted
        # model, which lets the residual stream itself flow in int8.
        name = f"__add_{self._add_idx}"
        self._add_idx += 1
        y = super().add(a, b)
        self._record(name, y, self.out_ranges)
        return y

    def _recorded(self, layer, x, *args, **kw):
        self._record(kw["name"], x, self.ranges)
        y = layer(x, *args, **kw)
        self._record(kw["name"], y, self.out_ranges)
        return y

    def conv_bn(self, x, filters, ksize, **kw):
        return self._recorded(super().conv_bn, x, filters, ksize, **kw)

    def depthwise_conv_bn(self, x, ksize, **kw):
        return self._recorded(super().depthwise_conv_bn, x, ksize, **kw)

    def binary_conv_bn(self, x, filters, ksize, **kw):
        # Only the output of a binary conv is quantisable (its input is one
        # bit by definition); an out range makes it write int8.
        y = super().binary_conv_bn(x, filters, ksize, **kw)
        self._record(kw["name"], y, self.out_ranges)
        return y

    def dense(self, x, units, **kw):
        return self._recorded(super().dense, x, units, **kw)


class ConvertBuilder(_Base):
    """Emits the packed inference artifact while tracing the forward.

      float conv   BN folded into the kernel (+ bias); with a calibrated
                   input range also per-channel int8 weights and the input
                   (and, with an output range, output) scale
      binary conv  latent weights -> sign -> OHWI bitpack; BN -> per-channel
                   post_mul/post_bias -> fused output transform; with an
                   output range also the transform that requantises to int8
      add          with an output range, an ``"add"`` entry under its
                   trace-order name ``__add_{i}`` holding the output scale
    """

    def __init__(self, params, int8_ranges=None, int8_out_ranges=None):
        self.params = params
        self.layers = {}
        self.int8_ranges = int8_ranges or {}
        # Output ranges enable the true-int8 pipeline: a layer with an
        # out_scale requantises to int8 instead of rescaling to float.
        self.int8_out_ranges = int8_out_ranges or {}
        self._add_idx = 0

    def add(self, a, b):
        name = f"__add_{self._add_idx}"
        self._add_idx += 1
        if name in self.int8_out_ranges:
            self.layers[name] = {
                "kind": "add",
                "out_scale": float(self.int8_out_ranges[name]) / 127.0,
            }
        return super().add(a, b)

    def _maybe_int8(self, name, entry, reduce_axes=None):
        """Per-channel int8 weight quantisation + input/output scales.

        ``reduce_axes``: kernel axes reduced for the per-channel scale (all
        but the last by default: per output channel; depthwise kernels pass
        (0, 1, 3) to scale per depth channel).
        """
        if name not in self.int8_ranges:
            return entry
        kernel = entry["kernel"]  # BN already folded
        if reduce_axes is None:
            reduce_axes = tuple(range(kernel.ndim - 1))
        w_scale = np.maximum(
            np.max(np.abs(kernel), axis=reduce_axes, keepdims=True),
            1e-9) / 127.0
        entry["kernel_int8"] = np.clip(
            np.round(kernel / w_scale), -127, 127).astype(np.int8)
        entry["w_scale"] = np.squeeze(w_scale, reduce_axes).astype(np.float32)
        entry["in_scale"] = float(self.int8_ranges[name]) / 127.0
        if name in self.int8_out_ranges:
            entry["out_scale"] = float(self.int8_out_ranges[name]) / 127.0
        del entry["kernel"]
        return entry

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        p = self.params[name]
        mul, bias = L.fold_batch_norm(p["bn"])
        kernel = np.asarray(p["kernel"], np.float32) * mul
        self.layers[name] = self._maybe_int8(name, {
            "kind": "conv", "kernel": kernel.astype(np.float32),
            "bias": bias, "stride": _pair(stride), "padding": padding,
            "activation": activation, "groups": groups,
            "dilation": _pair(dilation),
        })
        return L.batch_norm(
            L.conv2d(x, torch.as_tensor(p["kernel"]), _pair(stride), padding,
                     groups=groups, dilation=_pair(dilation)),
            _on(p["bn"], x))

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        p = self.params[name]
        mul, bias = L.fold_batch_norm(p["bn"])
        kernel = np.asarray(p["kernel"], np.float32) * mul.reshape(1, 1, -1, 1)
        self.layers[name] = self._maybe_int8(name, {
            "kind": "depthwise_conv", "kernel": kernel.astype(np.float32),
            "bias": bias, "stride": _pair(stride), "activation": activation,
        }, reduce_axes=(0, 1, 3))
        return L.batch_norm(
            L.depthwise_conv2d(x, torch.as_tensor(p["kernel"]),
                               _pair(stride)), _on(p["bn"], x))

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        return self._binary_conv(x, self.params[name], name, ksize,
                                 stride=stride, padding=padding,
                                 pad_value=pad_value, groups=groups,
                                 dilation=dilation, input_shift=input_shift)

    def binary_conv_pair(self, x, filters, *, names):
        """The pair as one layer under the first name: the two filters and
        BN transforms side by side (its input shift the pair's one, the same
        values under both names)."""
        first, second = names
        pa, pb = self.params[first], self.params[second]
        shift = np.asarray(pa["shift"], np.float32)
        if not np.array_equal(shift, np.asarray(pb["shift"], np.float32)):
            raise ValueError(f"{first} and {second} read one input: their "
                             "input shifts differ")
        joined = {
            "kernel": np.concatenate([np.asarray(pa["kernel"], np.float32),
                                      np.asarray(pb["kernel"], np.float32)],
                                     axis=-1),
            "bn": {k: np.concatenate([np.asarray(pa["bn"][k], np.float32),
                                      np.asarray(pb["bn"][k], np.float32)])
                   for k in pa["bn"]},
            "shift": shift}
        ranges = [self.int8_out_ranges[n] for n in names
                  if n in self.int8_out_ranges]
        return self._binary_conv(x, joined, first, 1, padding="VALID",
                                 input_shift=True,
                                 out_range=max(ranges) if ranges else None)

    def _rprelu_vectors(self, name, c):
        """The RPReLU's vectors, also written into the layer ``name``'s
        entry as ``rprelu_shift_in``, ``rprelu_slope`` and
        ``rprelu_shift_out``."""
        vectors = _rprelu_params(self.params[name], c)
        for key, v in zip(RPRELU_KEYS, vectors):
            self.layers[name][f"rprelu_{key}"] = np.asarray(v, np.float32)
        return vectors

    def _binary_conv(self, x, p, name, ksize, *, stride=1, padding="SAME",
                     pad_value=1, groups=1, dilation=1, input_shift=False,
                     out_range=None):
        """The artifact layer ``name`` of a binary conv with parameters
        ``p``, and the conv's float forward."""
        if out_range is None:
            out_range = self.int8_out_ranges.get(name)
        channels_in = int(x.shape[-1])
        post_mul, post_bias = L.fold_batch_norm(p["bn"])
        kh, kw = _pair(ksize)
        k = kh * kw * (channels_in // groups)
        transform = fuse_output_transform(post_mul, post_bias, k)
        w = np.asarray(p["kernel"], np.float32)  # (H, W, I/groups, O)
        w_ohwi = np.transpose(w, (3, 0, 1, 2))
        # The sign-flipped filter serves bitpacked output (thresholds need
        # the filter pre-multiplied by sign(post_mul)); it is re-binarised
        # and re-packed so its padding bits stay 0.
        flip = np.where(post_mul < 0, -1.0, 1.0).astype(np.float32)
        self.layers[name] = {
            "kind": "bconv",
            "packed_filter": bitpack_np(w_ohwi),
            "packed_filter_flipped": bitpack_np(
                np.where(w_ohwi * flip[:, None, None, None] < 0, -1.0, 1.0)),
            "thresholds": compute_output_thresholds(post_mul, post_bias, k),
            "multiplier": transform.multiplier,
            "bias": transform.bias,
            "clamp_min": transform.clamp_min,
            "clamp_max": transform.clamp_max,
            "channels_in": channels_in,
            "stride": _pair(stride),
            "padding": padding,
            "pad_value": pad_value,
            "groups": groups,
            "dilation": _pair(dilation),
        }
        if input_shift:
            shift = np.asarray(p["shift"], np.float32)
            self.layers[name]["shift"] = shift
            x = x + torch.as_tensor(shift).to(x.device)
        if out_range is not None:
            # int8-output binary conv: the requantisation is folded into the
            # per-channel transform, so the GEMM's epilogue writes int8.
            out_scale = float(out_range) / 127.0
            tr8 = fuse_output_transform(post_mul, post_bias, k,
                                        output_scale=out_scale)
            self.layers[name]["int8_multiplier"] = tr8.multiplier
            self.layers[name]["int8_bias"] = tr8.bias
            self.layers[name]["out_scale"] = out_scale
        return L.batch_norm(
            _float_binary_conv(x, torch.as_tensor(p["kernel"]).to(x.device),
                               _pair(stride), padding, pad_value,
                               groups=groups, dilation=_pair(dilation)),
            _on(p["bn"], x))

    def binary_dense_bn(self, x, units, *, name):
        p = self.params[name]
        channels_in = int(x.shape[-1])
        post_mul, post_bias = L.fold_batch_norm(p["bn"])
        transform = fuse_output_transform(post_mul, post_bias, channels_in)
        w = np.asarray(p["kernel"], np.float32)  # (C, units)
        flip = np.where(post_mul < 0, -1.0, 1.0).astype(np.float32)
        self.layers[name] = {
            "kind": "bdense",
            "packed_kernel": bitpack_np(np.where(w.T < 0, -1.0, 1.0)),
            "packed_kernel_flipped": bitpack_np(
                np.where(w.T * flip[:, None] < 0, -1.0, 1.0)),
            "thresholds": compute_output_thresholds(post_mul, post_bias,
                                                    channels_in),
            "multiplier": transform.multiplier,
            "bias": transform.bias,
            "clamp_min": transform.clamp_min,
            "clamp_max": transform.clamp_max,
            "channels_in": channels_in,
        }
        return L.batch_norm(
            _float_binary_dense(x, torch.as_tensor(p["kernel"]).to(x.device)),
            _on(p["bn"], x))

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        p = self.params[name]
        self.layers[name] = self._maybe_int8(name, {
            "kind": "dense",
            "kernel": np.asarray(p["kernel"], np.float32),
            "bias": np.asarray(p["bias"], np.float32) if use_bias else None,
            "activation": activation,
        })
        y = L.dense(x, torch.as_tensor(p["kernel"]),
                    torch.as_tensor(p["bias"]).to(x.device)
                    if use_bias else None)
        return L.apply_activation(y, activation)


class _Lazy:
    """An activation that a layer hands on before it is a plain tensor: a
    deferred conv, a packed-domain stream or an int8 tensor. Its consumer
    decides what runs: one that takes floats reads ``to_float()``
    (``_float_view``), and a forward that ends on it returns ``result()``
    (``_result``)."""

    channels: int

    def to_float(self):
        """The float view: what a layer that takes floats reads."""
        raise NotImplementedError

    def result(self):
        """The forward's output, where the value is the model's last."""
        return self.to_float()


def _float_view(x):
    """The float view of an activation, whichever form it takes."""
    return x.to_float() if isinstance(x, _Lazy) else x


def _result(x):
    """A forward's output as ``packed_apply`` returns it."""
    return x.result() if isinstance(x, _Lazy) else x


class _BinaryStream(_Lazy):
    """Lazily materialised output of a binary layer (packed domain).

    LCE decides statically whether a binary op's output is consumed packed
    (the next op is binary: write bitpacked words through thresholds,
    ``bitpack_activations_patterns.td:20-60``) or dense. Builders trace
    forward without lookahead, so the decision is made at the consumer: a
    binary layer returns this wrapper, and the representation the consumer
    pulls is the one that runs (memoised, so one consumer runs one conv).
    A model that ends on one returns its packed words.
    """

    def __init__(self, packed_fn, float_fn, channels: int):
        self._packed_fn, self._float_fn = packed_fn, float_fn
        self.channels = channels
        self._packed = self._float = None

    def packed(self):
        if self._packed is None:
            self._packed = self._packed_fn()
        return self._packed

    def to_float(self):
        if self._float is None:
            self._float = self._float_fn()
        return self._float

    result = packed


class Int8Tensor(_Lazy):
    """An int8 activation tensor with its symmetric scale (zero point 0).

    The unit of the true-int8 pipeline: a layer converted with an out_scale
    requantises to int8 and hands this wrapper to the next layer, which
    consumes the int8 values as they are, with no float round trip between
    consecutive int8 layers. Binary layers read signs straight off the int8
    values (bit = v < 0, exact at zero point 0). A model that ends on one
    returns it dequantised.
    """

    def __init__(self, values, scale: float):
        self.values = values
        self.scale = float(scale)

    @property
    def channels(self):
        return self.values.shape[-1]

    def to_float(self):
        return self.values.to(torch.float32) * self.scale


def _f32(value, like):
    """A Python float as a float32 scalar tensor on ``like``'s device.

    Dividing a tensor by a Python number multiplies by its reciprocal on
    CUDA; a tensor divisor keeps the IEEE division that the JAX package
    does, so a requantised value lands on the same side of a rounding tie.
    """
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _shifted(x, shift):
    """``x``, or ``x + shift`` in float32 (what a shifted binary conv
    signs) where a shift is given."""
    return x if shift is None else x.to(torch.float32) + shift


def _to_int8(y):
    """Round half away from zero and saturate to the symmetric int8 range."""
    return torch.clamp(round_half_away(y), -127, 127).to(torch.int8)


def concat(xs):
    """``torch.cat`` on the channel axis, the copy of every input into a new
    tensor, counted in ``concat.launches`` (``kernels.counts``: under a
    graph's capture, once per replay) on any device. Counted after the copy,
    which opens the captured segment it belongs to."""
    y = torch.cat(xs, dim=-1)
    counts.count(concat)
    return y


concat.launches = 0
concat.in_place = 0


def add_tail(x, y):
    """``_Base.add_tail`` on tensors: ``y`` added into ``x``'s last
    channels by ``torch.cat`` and an add, counted in ``add_tail.launches``
    (``kernels.counts``, as ``concat`` is) on any device. The builder's
    fused tail adds, which the block kernel runs, count in
    ``add_tail.launches`` and ``add_tail.fused``."""
    z = _add_into_tail(x, y)
    counts.count(add_tail)
    return z


add_tail.launches = 0
add_tail.fused = 0


def rprelu(x, shift_in, slope, shift_out):
    """ReActNet's RPReLU on a tensor (``kernels.residual.rprelu_plain``),
    counted in ``rprelu.launches`` (``kernels.counts``, as ``concat`` is)
    on any device. The builder's RPReLUs that the block kernel runs in its
    epilogue count in ``rprelu.launches`` and ``rprelu.fused``."""
    y = rprelu_plain(x, shift_in, slope, shift_out)
    counts.count(rprelu)
    return y


rprelu.launches = 0
rprelu.fused = 0


class _DeferredBConv(_Lazy):
    """A float-output binary conv on the block kernel whose execution waits
    for its consumer. QuickNet's ``x = add(x, binary_conv_bn(x, ...))`` runs
    as one fused block (``fused_with``); a dense layer's ``concat([x,
    binary_conv_bn(x, ...)])``, ``x`` the first channels of a wider buffer,
    writes the conv's channels after them (``written_after``); MeliusNet's
    ``add_tail(x, binary_conv_bn(x, ...))`` runs as the kernel's tail form
    (``tail_fused``). Any other consumer reads ``to_float()``: before a
    fused add the same kernel without the add; after it ``fused - x``, as
    the JAX package does, rather than a second conv that could differ from
    the fused one by a rounding. After a tail add written over ``x`` the
    conv's value alone is gone, and reading it raises.

    A conv with a ``threshold`` (ReActNet's learned shift of its input,
    added before the sign) is deferred only on a dense input, which no
    dense block's concatenation or tail add reads: it runs on the block
    kernel with its add and the RPReLU after it (``_FusedSum``); alone, it
    runs the block without the add on ``x + threshold``, made in
    float32.
    """

    def __init__(self, x, packed_filter, transform, params, block,
                 unpacked_filter, tap_delta, threshold=None):
        self.x = x
        self.channels = packed_filter.shape[0]
        self._args = (packed_filter, transform, params)
        self._block = block
        self._kw = dict(unpacked_filter=unpacked_filter, tap_delta=tap_delta)
        self.threshold = threshold
        self._value = None
        self._fused = None

    def _run(self, **kw):
        return self._block(self.x, *self._args, **self._kw, **kw)

    def to_float(self):
        if self._value is _OVERWRITTEN:
            raise RuntimeError("the conv's input was overwritten by its "
                               "fused tail add: its value alone is gone")
        if self._value is None:
            if self._fused is not None:
                self._value = self._fused - self.x.to(self._fused.dtype)
            elif self.threshold is not None:
                self._value = self._block(
                    _shifted(self.x, self.threshold), *self._args,
                    **self._kw, has_residual=False).to(self.x.dtype)
            else:
                self._value = self._run(has_residual=False)
        return self._value

    def fused_with(self, other):
        """``add(other, self)`` as one block, where ``other`` is the conv's
        input and the conv has not run alone; else None. A thresholded
        conv's sum waits for its consumer (``_FusedSum``)."""
        if other is not self.x or self._value is not None:
            return None
        if self.threshold is not None:
            return _FusedSum(self)
        if self._fused is None:
            self._fused = self._run(has_residual=True)
        return self._fused

    def written_after(self, stream, buf):
        """``concat([stream, self])`` with nothing copied, where ``stream``
        is the conv's input, the written first channels of ``buf``, and the
        conv has not run: it runs into the channels after the stream, and
        the result is the wider prefix of ``buf``. None where the conv's
        channels do not fit or any of these does not hold."""
        if (buf is None or stream is not self.x or self._value is not None
                or self._fused is not None):
            return None
        width = stream.shape[-1]
        end = width + self.channels
        if end > buf.shape[-1]:
            return None
        self._value = self._run(has_residual=False,
                                out=buf[..., width:end])
        return buf[..., :end]

    def tail_fused(self, stream):
        """``add_tail(stream, self)`` as one block, written over the
        stream's last channels, where ``stream`` is the conv's input, at
        least as wide as the conv, and the conv has not run; else None. The
        kernel's tail form reads every channel of the stream, so it writes
        into a new tensor, which is then copied into place: the stream is
        returned, and the conv's value alone is gone."""
        k = self.channels
        if (stream is not self.x or self._value is not None
                or self._fused is not None or stream.shape[-1] < k):
            return None
        stream[..., -k:].copy_(self._run(has_residual="tail"))
        self._value = _OVERWRITTEN
        return stream


_OVERWRITTEN = object()  # a deferred conv's value after its tail add


class _FusedSum(_Lazy):
    """ReActNet's ``add(x, conv)`` of a thresholded deferred conv and its
    input, waiting for its consumer: an RPReLU of it runs in the same block
    kernel launch, with the threshold in the signing (``with_rprelu``); any
    other consumer reads ``to_float()``, the conv alone, then the add, which
    equal the fused kernel's sum bit for bit."""

    def __init__(self, conv):
        self.conv = conv
        self.channels = conv.channels
        self._value = None

    def to_float(self):
        if self._value is None:
            self._value = self.conv.x + self.conv.to_float()
        return self._value

    def with_rprelu(self, vectors):
        """The sum's RPReLU (``vectors``: shift_in, slope, shift_out) by
        one launch of the block kernel's ReActNet form."""
        c = self.conv
        return c._run(has_residual=True, threshold=c.threshold,
                      rprelu=vectors)


class _DeferredStem(_Lazy):
    """A float conv that the stem kernel takes (``kernels.stem.
    stem_supported``: a 7x7/2 conv of the images to 64 channels, say) on a
    bf16 stream, whose execution waits for its consumer. A 3x3/2 SAME max
    pool of it is ``pooled()``, the conv and the pool in one kernel; any
    other consumer reads ``to_float()``, the conv alone by the builder's
    float chain. Each runs once."""

    POOL = ((3, 3), (2, 2), "SAME")  # (pool_size, stride, padding)

    def __init__(self, chain, conv_pool):
        self.channels = _stem.C_OUT
        self._chain, self._conv_pool = chain, conv_pool
        self._value = self._pooled = None

    def to_float(self):
        if self._value is None:
            self._value = self._chain()
        return self._value

    def pooled(self):
        if self._pooled is None:
            self._pooled = self._conv_pool()
        return self._pooled


class PackedBuilder(_Base):
    """Packed inference forward over runtime layers.

    Float layers take their input in ``compute_dtype``, accumulate in
    float32, and store their output in ``compute_dtype`` (bf16 by default:
    the activation stream between layers). ``return_logits`` makes the final
    softmax the identity.

    ``kernel`` chooses the lowering of the binary layers, with the JAX
    package's names and meanings:

      "auto"      per layer from the selection table (``kernels.select``,
                  measured on the card): "residual" runs the block kernel,
                  fused with its residual add when that is the consumer;
                  "bgemm" runs ``quantize`` -> the binary GEMM; "mxu" the
                  exact int8 conv or product on +-1 operands; "s2d" that conv
                  after a space-to-depth retile
      "residual"  the block kernel wherever it applies, the table elsewhere
                  (a binary dense takes "mxu", as in JAX)
      "bgemm", "mxu", "s2d"
                  that lowering for every binary layer ("s2d" gives "mxu"
                  where the retile cannot run, and a binary dense takes
                  "mxu")
      "reference" the packed oracle (``quantize`` -> ``bconv2d_reference``;
                  a binary dense takes the GEMM, as in JAX)

    JAX's ``binary_dtype`` (the TPU MXU's operand type) has no meaning on
    the card and is not taken: the integer lowerings are int8 throughout.

    The true-int8 pipeline (an artifact converted with calibrated ranges): a
    conv, depthwise conv or dense layer with ``kernel_int8`` multiplies int8
    by int8 into int32 (``layers.conv2d_int8`` and its siblings); with an
    ``out_scale`` it requantises and returns an ``Int8Tensor``, which the
    next int8 layer, a max pool, a flatten and a calibrated residual add
    (the int8 ADD) consume without a float round trip. A binary conv or
    dense reads the signs off an ``Int8Tensor``'s values; a binary conv with
    an ``out_scale`` writes int8 through the binary GEMM's int8 epilogue.
    The residual block kernel reads bfloat16 or float32 only and never sees
    an ``Int8Tensor``: a binary conv with int8 output always takes the GEMM,
    whatever ``kernel`` says, and its residual add is the int8 ADD; a binary
    layer with int8 input takes no block kernel. Every other consumer takes
    the float view (``Int8Tensor.to_float``).

    A float conv that the stem kernel takes (``kernels.stem``: at most 4
    input channels, stride 2, SAME, 64 output channels, K <= 160; the 7x7
    stem of Bi-RealNet-18 and the BinaryDenseNets) on a bf16 stream waits
    for its consumer (``_DeferredStem``): a 3x3/2 SAME max pool runs with
    it as one kernel, on the card the hand-written one; any other consumer
    gets the float chain, as every other float conv does. A dense block's
    transition (``transition``: a 1x1 conv, then a 2x2/2 average pool) on a
    bf16 stream that ``kernels.transition`` takes is one kernel likewise.

    ReActNet-A's binary convs declare a learned shift of their input
    (``input_shift=True``, the layer's ``shift``), added in float32 before
    the sign. A stride-1 3x3 conv on the block kernel with its add of ``x``
    waits with that add (``_FusedSum``) for an RPReLU (``rprelu``), which
    runs in the same launch with the shift as the band's threshold; every
    other shifted conv, and every other consumer, runs on ``x + shift``
    made in float32, and an RPReLU elsewhere by the plain chain. The
    doubling 1x1 pair (``binary_conv_pair``) is the one conv of twice the
    width that ``convert_model`` joins it into.

    ``domain="packed"``: binary layers chain through bitpacked activations
    (convert-time thresholds and sign-flipped filters), pooling and flatten
    stay packed between them, and non-binary consumers pull the float view.
    There "residual" and "s2d" mean "auto", which asks the table's packed
    domain. An artifact without thresholds runs in the float domain.

    ``residual_block`` and ``gemm`` pick between kernel and plain version by
    the tensor's device; the plain versions may be passed to run them on the
    card for comparison.
    """

    def __init__(self, layers, kernel="auto", compute_dtype=torch.bfloat16,
                 return_logits=False, residual_block=binary_residual_block,
                 gemm=bgemm, domain="float"):
        if domain not in ("float", "packed"):
            raise ValueError(f"unknown domain {domain!r}")
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                             f"{KERNELS}")
        self.layers = layers
        self.kernel = kernel
        self.compute_dtype = compute_dtype
        self.return_logits = return_logits
        self.residual_block = residual_block
        self.gemm = gemm
        self.domain = domain
        self._add_idx = 0
        # The buffers ``dense_block`` laid out, each under the id of its
        # newest stream (the first channels of it written so far), held for
        # as long as that stream lives and no longer.
        self._buffers = {}

    def _lay_out(self, stream, buf):
        """Record ``stream``, the written first channels of ``buf``, as the
        stream that the next layer of its dense block may write after."""
        key, buffers = id(stream), self._buffers
        buffers[key] = buf, weakref.ref(stream,
                                        lambda _: buffers.pop(key, None))

    def _buffer_of(self, stream):
        """The buffer whose newest stream is ``stream``, or None."""
        return self._buffers.get(id(stream), (None,))[0]

    def _store(self, y):
        """Materialise an inter-layer activation in the compute dtype."""
        return y.to(self.compute_dtype)

    def max_pool(self, x, pool_size, stride=None, padding="SAME"):
        ps = _pair(pool_size)
        st = _pair(stride) if stride is not None else ps
        if isinstance(x, _DeferredStem) and (ps, st,
                                             padding) == _DeferredStem.POOL:
            return x.pooled()
        if isinstance(x, Int8Tensor):
            # max commutes with the positive scale: pool the int8 values.
            return Int8Tensor(
                super().max_pool(x.values, pool_size, stride, padding),
                x.scale)
        if isinstance(x, _BinaryStream):
            # sign is monotonic, so max commutes with it: pooling the packed
            # words (bitwise AND) equals sign(float max pool).
            pad = Padding.SAME if padding == "SAME" else Padding.VALID
            return _BinaryStream(
                lambda: bmaxpool2d(x.packed(), ps, st, pad),
                lambda: super(PackedBuilder, self).max_pool(
                    x.to_float(), pool_size, stride, padding),
                x.channels)
        return super().max_pool(_float_view(x), pool_size, stride, padding)

    def avg_pool(self, x, *a, **kw):
        return super().avg_pool(_float_view(x), *a, **kw)

    def flatten(self, x):
        if isinstance(x, Int8Tensor):
            return Int8Tensor(super().flatten(x.values), x.scale)
        if isinstance(x, _BinaryStream) and x.channels % 32 == 0:
            # Exact only when no padding bits would interleave into the
            # flattened word stream.
            return _BinaryStream(
                lambda: x.packed().reshape(x.packed().shape[0], -1),
                lambda: super(PackedBuilder, self).flatten(x.to_float()),
                -1)
        return super().flatten(_float_view(x))

    def global_avg_pool(self, x):
        return super().global_avg_pool(_float_view(x))

    def add(self, a, b):
        # Counted before the fused-add shortcut, so that every builder gives
        # the same add the same name.
        name = f"__add_{self._add_idx}"
        self._add_idx += 1
        for u, v in ((a, b), (b, a)):
            if (isinstance(v, _DeferredBConv)
                    and (fused := v.fused_with(u)) is not None):
                return fused
        entry = self.layers.get(name)
        if (entry is not None and entry.get("kind") == "add"
                and isinstance(a, Int8Tensor) and isinstance(b, Int8Tensor)):
            # int8 residual add (TFLite int8 ADD semantics): rescale both
            # operands to the calibrated output scale, round, saturate. The
            # residual stream stays int8 end to end.
            so = float(entry["out_scale"])
            y = (a.values.to(torch.float32) * (a.scale / so)
                 + b.values.to(torch.float32) * (b.scale / so))
            return Int8Tensor(_to_int8(y), so)
        return super().add(_float_view(a), _float_view(b))

    def dense_block(self, x, width):
        """A float stream entering a dense block that grows it to ``width``
        channels, stored once into the first channels of a buffer of that
        width, where the block's layers write theirs: the stream goes on as
        that channel prefix of the buffer. An int8 or packed stream, or one
        in another dtype than the compute dtype, is returned as it is."""
        if (not isinstance(x, torch.Tensor) or x.dtype != self.compute_dtype
                or width <= x.shape[-1]):
            return x
        buf = torch.empty((*x.shape[:-1], width), dtype=x.dtype,
                          device=x.device)
        stream = buf[..., :x.shape[-1]]
        stream.copy_(x)
        self._lay_out(stream, buf)
        return stream

    def concat(self, xs):
        """``concat`` of the float views, except where a dense block's
        newest stream meets the conv of the layer that reads it: the conv
        runs into the channels after the stream and the concatenation is
        the wider prefix of the buffer, nothing copied (counted in
        ``concat.in_place`` too)."""
        if len(xs) == 2 and isinstance(xs[1], _DeferredBConv):
            s, y = xs
            buf = self._buffer_of(s)
            grown = y.written_after(s, buf)
            if grown is not None:
                # ``s`` has grown: another concatenation onto it would
                # overwrite what ``y`` wrote, so it copies.
                del self._buffers[id(s)]
                self._lay_out(grown, buf)
                counts.count(concat)
                counts.count(concat, "in_place")
                return grown
        return concat([_float_view(x) for x in xs])

    def add_tail(self, x, y):
        """``add_tail`` of the float views, except where ``y`` is the
        deferred conv of ``x`` and ``x`` is a dense block's newest stream
        (``dense_block``): then the block kernel's tail form adds ``x``'s
        last channels and the result is written over them, so the stream
        stays its buffer's newest prefix and the next dense layer still
        concatenates in place (counted in ``add_tail.fused`` too). The
        stream is overwritten: a model reads only the result after it."""
        if (isinstance(y, _DeferredBConv)
                and self._buffer_of(x) is not None
                and y.tail_fused(x) is not None):
            counts.count(add_tail)
            counts.count(add_tail, "fused")
            return x
        return add_tail(_float_view(x), _float_view(y))

    def add_repeated(self, y, r):
        return super().add_repeated(_float_view(y), _float_view(r))

    binary_conv_pair = _joined_pair

    def rprelu(self, x, name):
        """The RPReLU of the layer ``name`` (its ``rprelu_*`` vectors):
        where ``x`` is a thresholded conv's sum with its input
        (``_FusedSum``), in that block's kernel launch (counted in
        ``rprelu.fused`` too); else by ``rprelu`` on the float view."""
        a = self.layers[name]
        vectors = tuple(a[f"rprelu_{k}"] for k in RPRELU_KEYS)
        if isinstance(x, _FusedSum):
            y = x.with_rprelu(vectors)
            counts.count(rprelu)
            counts.count(rprelu, "fused")
            return y
        return rprelu(_float_view(x), *vectors)

    def transition(self, x, filters, *, name):
        """The transition's conv and pool in one kernel
        (``kernels.transition``, on the card the hand-written one) where the
        stream is bf16 and the kernel takes the float conv
        (``transition_supported``), with the filter prepared at load
        (``transition_filter``); else the two layers as in ``_Base``."""
        a = self.layers[name]
        if (self.compute_dtype == torch.bfloat16 and "kernel_int8" not in a
                and _transition.transition_supported(x, a["kernel"])):
            bits = a.get("transition_filter")
            return _transition.transition_conv_pool(
                x, a["kernel"], a["bias"],
                filter_bf16=None if bits is None
                else bits.view(torch.bfloat16))
        return super().transition(x, filters, name=name)

    def activation(self, x, kind):
        return super().activation(_float_view(x), kind)

    def softmax(self, x):
        x = _float_view(x)
        if self.return_logits:
            return x.to(torch.float32)
        return super().softmax(x)

    def _int8_in(self, x, a):
        """int8 input values and their scale, quantising floats on entry.

        An ``Int8Tensor`` is consumed as it is, at its producer's scale."""
        if isinstance(x, Int8Tensor):
            return x.values, x.scale
        x = _float_view(x).to(torch.float32)
        return _to_int8(x / _f32(a["in_scale"], x)), a["in_scale"]

    def _int8_out(self, acc, scale, a, activation, store=True):
        """Rescale an int32 accumulator: to an ``Int8Tensor`` when the layer
        has an out_scale (requantise, with the activation applied in the
        quantised domain), else to float. Float32 throughout, the product
        and the sum rounded separately, in the JAX package's order."""
        bias = a.get("bias")
        accf = acc.to(torch.float32)
        if "out_scale" in a:
            out_s = _f32(a["out_scale"], accf)
            y = accf * (scale / out_s)
            if bias is not None:
                y = y + bias / out_s
            if activation == "relu":
                y = torch.clamp(y, min=0.0)
            elif activation == "relu6":
                y = torch.clamp(y, 0.0, 6.0 / a["out_scale"])
            elif activation is not None:
                raise ValueError(
                    f"unsupported activation {activation!r} on an "
                    "int8-output layer")
            return Int8Tensor(_to_int8(y), a["out_scale"])
        y = accf * scale
        if bias is not None:
            y = y + bias
        y = L.apply_activation(y, activation)
        return self._store(y) if store else y

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        a = self.layers[name]
        if "kernel_int8" in a:
            x_q, in_s = self._int8_in(x, a)
            acc = L.conv2d_int8(x_q, a["kernel_int8"], _pair(stride), padding,
                                groups=groups, dilation=_pair(dilation))
            return self._int8_out(acc, a["w_scale"] * in_s, a, activation)
        x = _float_view(x)

        def chain():
            y = L.conv2d(x.to(self.compute_dtype), a["kernel"], _pair(stride),
                         padding, groups=groups, dilation=_pair(dilation))
            y = y + a["bias"]
            return self._store(L.apply_activation(y, activation))

        if self.compute_dtype == torch.bfloat16 and _stem.stem_supported(
                x, a["kernel"], _pair(stride), padding, groups,
                _pair(dilation), activation):
            bits = a.get("stem_filter")
            return _DeferredStem(chain, lambda: _stem.stem_conv_pool(
                x, a["kernel"], a["bias"], _pair(stride), activation,
                filter_bf16=None if bits is None
                else bits.view(torch.bfloat16)))
        return chain()

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        a = self.layers[name]
        if "kernel_int8" in a:
            x_q, in_s = self._int8_in(x, a)
            acc = L.depthwise_conv2d_int8(x_q, a["kernel_int8"],
                                          _pair(stride))
            return self._int8_out(acc, a["w_scale"] * in_s, a, activation)
        y = L.depthwise_conv2d(_float_view(x).to(self.compute_dtype),
                               a["kernel"], _pair(stride))
        y = y + a["bias"]
        return self._store(L.apply_activation(y, activation))

    def _packed_in(self, x, shift=None):
        """A function giving the packed words of a binary layer's input
        (of the input plus ``shift``, where one is given)."""
        if isinstance(x, _BinaryStream) and shift is None:
            return x.packed
        x = _float_view(x)
        return lambda: quantize(_shifted(x, shift))

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        a = self.layers[name]
        # ReActNet's learned shift of the input, added before the sign.
        shift = a["shift"] if input_shift else None
        if isinstance(x, Int8Tensor):
            # Signs are read straight off the int8 values (bit = v < 0,
            # exact at zero point 0): no dequantisation pass, but where the
            # input is shifted first.
            x = x.values if shift is None else x.to_float()
        params = BConv2DParams(
            channels_in=int(a["channels_in"]),
            stride=_pair(stride),
            dilation=_pair(a.get("dilation", dilation)),
            padding=Padding.SAME if padding == "SAME" else Padding.VALID,
            pad_value=int(a["pad_value"]),
            groups=int(a.get("groups", groups)),
            activation=Activation.NONE,
        )
        transform = OutputTransform(
            clamp_min=int(a["clamp_min"]), clamp_max=int(a["clamp_max"]),
            multiplier=a["multiplier"], bias=a["bias"])
        pf = a["packed_filter"]
        upf = a.get("filter_pm1")
        kh, kw = _pair(ksize)

        def lowering(n, in_h, in_w, domain, out_kind, float_in=True):
            out_h, out_w, _, _ = params.output_spatial(in_h, in_w, kh, kw)
            return layer_lowering(self.kernel, dict(
                c_in=params.channels_in, c_out=filters, fh=kh, fw=kw,
                m=n * out_h * out_w, stride=params.stride, padding=padding,
                pad_value=params.pad_value, groups=params.groups,
                dilation=params.dilation), domain, out_kind, float_in)

        if self.domain == "packed" and "thresholds" in a:
            packed_in = self._packed_in(x, shift)

            def run(out_kind):
                words = packed_in()
                k = lowering(*words.shape[:3], "packed", out_kind)
                if out_kind == "bitpacked":
                    return bconv2d(
                        words, a["packed_filter_flipped"],
                        OutputTransform(thresholds=a["thresholds"]), params,
                        output_kind="bitpacked", kernel=k, gemm=self.gemm)
                return self._store(bconv2d(
                    words, pf, transform, params, output_kind="float",
                    kernel=k, gemm=self.gemm, unpacked_filter=upf))

            return _BinaryStream(lambda: run("bitpacked"),
                                 lambda: run("float"), filters)

        x = _float_view(x)
        if "out_scale" in a:
            # int8-output binary conv: the requantisation is folded into the
            # transform and the GEMM's int8 epilogue writes int8, which flows
            # on as an Int8Tensor, whatever ``kernel`` says.
            tr8 = OutputTransform(
                clamp_min=transform.clamp_min, clamp_max=transform.clamp_max,
                multiplier=a["int8_multiplier"], bias=a["int8_bias"])
            return Int8Tensor(
                bconv2d(quantize(_shifted(x, shift)), pf, tr8, params,
                        output_kind="int8", gemm=self.gemm), a["out_scale"])
        # The block kernel reads bfloat16 or float32 activations only.
        k = lowering(*x.shape[:3], "float", "float", x.is_floating_point())
        if k == "residual":
            delta = a.get("tap_delta")
            if shift is not None:
                if x.shape[-1] == filters and x.is_contiguous():
                    # ReActNet's: the threshold in the block kernel's
                    # signing, where the conv's add of x follows.
                    return _DeferredBConv(x, pf, transform, params,
                                          self.residual_block, upf, delta,
                                          threshold=shift)
            elif x.shape[-1] == filters or self._buffer_of(x) is not None:
                # A residual block's conv waits for its add, a dense
                # layer's for its concatenation.
                return _DeferredBConv(x, pf, transform, params,
                                      self.residual_block, upf, delta)
            return self._store(self.residual_block(
                _shifted(x, shift), pf, transform, params,
                has_residual=False, unpacked_filter=upf, tap_delta=delta))
        x = _shifted(x, shift)
        if k == "s2d":
            y = bconv2d_mxu_s2d(x, pf, transform, params, "float",
                                unpacked_filter=upf)
        elif k == "mxu":
            y = bconv2d_mxu_float_in(x, pf, transform, params, "float",
                                     unpacked_filter=upf)
        else:  # "bgemm" and "reference"
            y = bconv2d(quantize(x), pf, transform, params,
                        output_kind="float", gemm=self.gemm, kernel=k)
        return self._store(y)

    def binary_dense_bn(self, x, units, *, name):
        if isinstance(x, Int8Tensor):
            x = x.values  # v < 0 is the sign at zero point 0
        a = self.layers[name]
        c_in = int(a["channels_in"])
        transform = OutputTransform(
            clamp_min=int(a["clamp_min"]), clamp_max=int(a["clamp_max"]),
            multiplier=a["multiplier"], bias=a["bias"])
        float_out = dict(multiplier=a["multiplier"], bias=a["bias"],
                         clamp_min=int(a["clamp_min"]),
                         clamp_max=int(a["clamp_max"]), out_kind="float")
        if self.domain == "packed" and "thresholds" in a:
            packed_in = self._packed_in(x)

            def run(out_kind):
                words = packed_in()
                kernel = self._dense_kernel("packed", c_in, units,
                                            words.shape[0], out_kind)
                if out_kind == "bitpacked":
                    flipped = a["packed_kernel_flipped"]
                    if kernel == "mxu":
                        return bdense_mxu(
                            words, bitunpack(flipped, c_in,
                                             dtype=torch.int8).t(),
                            OutputTransform(thresholds=a["thresholds"]),
                            "bitpacked")
                    return self.gemm(words, flipped.t(),
                                     thresholds=a["thresholds"],
                                     out_kind="bitpacked")
                if kernel == "mxu":
                    return self._store(bdense_mxu(
                        words, self._kernel_pm1(a, c_in), transform))
                return self._store(self.gemm(
                    words, a["packed_kernel"].t(), **float_out))

            return _BinaryStream(lambda: run("bitpacked"),
                                 lambda: run("float"), units)
        x = _float_view(x)
        kernel = self._dense_kernel("float", c_in, units, x.shape[0],
                                    "float")
        if kernel == "mxu":
            return self._store(bdense_mxu_float_in(
                x, self._kernel_pm1(a, c_in), transform))
        lhs = quantize(x)  # (M, Cp)
        return self._store(self.gemm(lhs, a["packed_kernel"].t(), **float_out))

    def _dense_kernel(self, domain, c_in, units, m, out_kind):
        """A binary dense's lowering: "mxu" or "bgemm"."""
        return layer_lowering(self.kernel, dict(c_in=c_in, units=units, m=m),
                              domain, out_kind)

    @staticmethod
    def _kernel_pm1(a, c_in):
        """The (C, units) +-1 int8 kernel, unpacked once at load when the
        runtime prepared it."""
        if "kernel_pm1" in a:
            return a["kernel_pm1"]
        return bitunpack(a["packed_kernel"], c_in, dtype=torch.int8).t()

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        a = self.layers[name]
        if "kernel_int8" in a:
            x_q, in_s = self._int8_in(x, a)
            acc = L.dense_int8(x_q, a["kernel_int8"])
            return self._int8_out(acc, a["w_scale"] * in_s, a, activation,
                                  store=False)
        y = L.dense(_float_view(x).to(self.compute_dtype), a["kernel"])
        if a["bias"] is not None:
            y = y + a["bias"]
        return L.apply_activation(y, activation)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _trace(spec, builder):
    x = torch.empty((1, *spec.input_size, 3), dtype=torch.float32,
                    device="meta")
    spec.forward(builder, x)


def init_model(spec, seed=0, randomize_bn=False):
    """Float parameter tree (layer name -> dict of CPU tensors)."""
    b = InitBuilder(seed=seed, randomize_bn=randomize_bn)
    _trace(spec, b)
    return b.params


def float_apply(spec, params, x, device="cuda", operand_dtype=None):
    """QAT float forward (the oracle) on ``device``, the card by default.

    Float32 throughout by default. ``operand_dtype=torch.bfloat16`` rounds
    the operands of the float convs and dense layers to bfloat16 and sums
    in float32, as a float32 conv or matmul at XLA's default precision does
    on a TPU: the oracle of the JAX package's TPU records. Gradients flow
    (``ste_sign`` passes them straight through), so a caller that only
    evaluates wraps the call in ``torch.no_grad()``."""
    device = resolve_device(device)
    with exact_float32():
        return spec.forward(FloatBuilder(params, operand_dtype),
                            torch.as_tensor(x).to(device))


def convert_model(spec, params, int8_ranges=None, int8_out_ranges=None):
    """Float params -> packed artifact layer dict (numpy, as on disk).

    ``int8_ranges`` (from ``calibrate_model``) also quantises the listed
    non-binary layers to int8 weights and activation scales;
    ``int8_out_ranges`` makes those layers, the listed binary convs and the
    listed residual adds emit int8 tensors, so that consecutive int8 layers
    exchange int8 directly (the true-int8 pipeline)."""
    b = ConvertBuilder(params, int8_ranges=int8_ranges,
                       int8_out_ranges=int8_out_ranges)
    _trace(spec, b)
    return b.layers


def calibrate_model(spec, params, batches, with_outputs=False, device="cuda"):
    """Record per-layer activation abs-max ranges over calibration batches,
    running the float forward on ``device`` (the card by default).

    Returns the input-range dict; with ``with_outputs=True`` returns
    ``(in_ranges, out_ranges)`` for the true-int8 pipeline."""
    device = resolve_device(device)
    b = CalibrateBuilder(params)
    with torch.no_grad(), exact_float32():
        for x in batches:
            b._add_idx = 0  # the adds' names restart with every forward
            spec.forward(b, torch.as_tensor(np.asarray(x, np.float32))
                         .to(device))
    if with_outputs:
        return b.ranges, b.out_ranges
    return b.ranges


def prepare_runtime_arrays(layers, spec=None):
    """Add once-unpacked +-1 int8 filters to artifact layers (numpy):

      bconv:  ``filter_pm1`` (FH, FW, C, O)
      bdense: ``kernel_pm1`` (C, units)

    to a conv that the stem kernel may take (``kernels.stem``: a (KH, KW,
    C <= 4, 64) kernel with K <= 160), ``stem_filter`` (64, 160): the kernel
    rounded to bf16 in the stem kernel's K order (``kernels.stem.
    stem_filter``), held as its int16 bit patterns (numpy has no bf16),

    with the model's ``spec``, to the conv of each of its transitions
    (``models.shapes.transition_layers``) that the transition kernel may
    take (``kernels.transition.takes_filter``), ``transition_filter``
    (C_out, C_in): the kernel rounded to bf16 (``kernels.transition.
    transition_filter``), held likewise; no other 1x1 conv gets one,

    and, to a SAME zero-padded bconv, ``tap_delta`` (O, FH * FW) int32:
    what each out-of-image tap adds to each output channel's accumulator
    (``core.reference.zero_padding_tap_delta``), which the block kernel
    adds in its epilogue, so that no forward computes it again. It derives
    from ``packed_filter``: whoever changes the filter in place changes it
    too.

    The plain versions contract the +-1 filters; the CUDA kernel reads the
    packed words themselves.
    """
    def unpack(words, channels):
        w = torch.from_numpy(np.array(words, order="C").view(np.int32))
        return bitunpack(w, channels, dtype=torch.int8).numpy()

    transitions = set()
    if spec is not None:
        from .shapes import transition_layers

        transitions = set(transition_layers(spec))
    out = {}
    for name, a in layers.items():
        a = dict(a)
        if a.get("kind") == "bconv" and "filter_pm1" not in a:
            cg = int(a["channels_in"]) // int(a.get("groups", 1))
            a["filter_pm1"] = np.ascontiguousarray(
                unpack(a["packed_filter"], cg).transpose(1, 2, 3, 0))
        elif a.get("kind") == "bdense" and "kernel_pm1" not in a:
            a["kernel_pm1"] = np.ascontiguousarray(
                unpack(a["packed_kernel"], int(a["channels_in"])).T)
        elif (a.get("kind") == "conv" and "kernel" in a
              and "stem_filter" not in a
              and _stem.takes_filter(np.shape(a["kernel"]))):
            a["stem_filter"] = _stem.stem_filter(torch.as_tensor(
                np.asarray(a["kernel"], np.float32))).view(torch.int16).numpy()
        elif (name in transitions and "kernel" in a
              and "transition_filter" not in a
              and _transition.takes_filter(np.shape(a["kernel"]))):
            a["transition_filter"] = _transition.transition_filter(
                torch.as_tensor(np.asarray(a["kernel"], np.float32))).view(
                    torch.int16).numpy()
        if (a.get("kind") == "bconv" and "tap_delta" not in a
                and a.get("padding", "SAME") == "SAME"
                and int(a["pad_value"]) == 0):
            words = torch.from_numpy(
                np.array(a["packed_filter"], order="C").view(np.int32))
            a["tap_delta"] = zero_padding_tap_delta(words, BConv2DParams(
                channels_in=int(a["channels_in"]),
                groups=int(a.get("groups", 1)), pad_value=0)).numpy()
        out[name] = a
    return out


@contextlib.contextmanager
def _forward_scope(compute_dtype):
    """The scope of a packed forward: inference mode, and exact float32
    (TF32 off) for a float32 stream."""
    with torch.inference_mode(), (
            exact_float32() if compute_dtype == torch.float32
            else contextlib.nullcontext()):
        yield


def packed_apply(spec, layers, x, kernel="auto", compute_dtype=torch.bfloat16,
                 return_logits=False, device="cuda",
                 residual_block=binary_residual_block, gemm=bgemm,
                 domain="float"):
    """Packed inference forward on ``device`` (the card by default).

    ``kernel`` chooses the binary layers' lowering (see ``PackedBuilder``).
    With ``compute_dtype=torch.float32`` the forward runs with TF32 off, so
    its float layers are float32 as on the CPU.

    ``layers`` are artifact layers (numpy) or runtime layers (tensors).
    ``domain="packed"`` chains binary layers through bitpacked activations
    (see ``PackedBuilder``); a model that ends on a binary layer then returns
    its packed words. An artifact converted with int8 ranges runs its int8
    layers on ``Int8Tensor``s: int8 convs, the int8 ADD, and binary convs
    that write int8 through the binary GEMM (the residual block kernel never
    sees an ``Int8Tensor``); a model that ends on an int8 layer is
    dequantised to float. ``residual_block`` and ``gemm`` may be
    ``binary_residual_block_plain`` and ``bgemm_plain`` to run the plain
    versions on the card for comparison.
    """
    device = resolve_device(device)
    layers = layers_from_numpy(layers, device)
    x = torch.as_tensor(x).to(device)
    builder = PackedBuilder(layers, kernel=kernel,
                            compute_dtype=compute_dtype,
                            return_logits=return_logits,
                            residual_block=residual_block, gemm=gemm,
                            domain=domain)
    with _forward_scope(compute_dtype):
        return _result(spec.forward(builder, x))

