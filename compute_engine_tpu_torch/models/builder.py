"""Model builders: one architecture definition, several execution modes.

The port of ``compute_engine_tpu.models.builder`` for the float-domain
inference path:

  InitBuilder     creates the float parameter tree (Keras layouts) from a
                  numpy seed, calling the rng in the same order as the JAX
                  package, so both give the same weights bit for bit
  ConvertBuilder  emits the packed inference artifact (BN folding, sign
                  binarisation, bitpacking) as numpy arrays, identical to the
                  JAX package's
  PackedBuilder   packed inference forward, in the float domain or, for
                  chains of binary layers, in the packed domain

Init and Convert trace shapes on ``torch.device("meta")`` (the counterpart of
``jax.eval_shape``): no activation math runs, only the host-side numpy
weight transformation.

Parameter trees map layer names to dicts of float32 CPU tensors; artifact
layers are numpy (``uint32`` packed words) as on disk; the runtime layers
that PackedBuilder reads are tensors on the run's device
(``interop.layers_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitpack import bitpack_np, bitunpack
from ..core.params import BConv2DParams, tflite_same_padding
from ..core.transforms import (OutputTransform, compute_output_thresholds,
                               fuse_output_transform)
from ..core.types import Activation, Padding
from ..device import resolve_device
from ..interop import layers_from_numpy
from ..kernels.bgemm import bgemm
from ..kernels.residual import binary_residual_block, residual_block_supported
from ..ops import bconv2d, bmaxpool2d, quantize
from . import layers as L

__all__ = ["InitBuilder", "ConvertBuilder", "PackedBuilder", "init_model",
           "convert_model", "packed_apply", "prepare_runtime_arrays"]


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

    def flatten(self, x):
        return x.reshape(x.shape[0], -1)

    def activation(self, x, kind):
        return L.apply_activation(x, kind)

    def softmax(self, x):
        return torch.softmax(x.to(torch.float32), dim=-1)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


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
                       pad_value=1, name, groups=1, dilation=1):
        kh, kw = _pair(ksize)
        c = x.shape[-1] // groups
        # Latent real-valued weights, binarised by ste_sign at use.
        kernel = self.rng.uniform(-1, 1,
                                  (kh, kw, c, filters)).astype(np.float32)
        p = self._new(name, kernel, self._bn(filters))
        return L.batch_norm(
            _float_binary_conv(x, p["kernel"].to(x.device), _pair(stride),
                               padding, pad_value, groups=groups,
                               dilation=_pair(dilation)), _on(p["bn"], x))

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


class ConvertBuilder(_Base):
    """Emits the packed inference artifact while tracing the forward.

      float conv   BN folded into the kernel (+ bias)
      binary conv  latent weights -> sign -> OHWI bitpack; BN -> per-channel
                   post_mul/post_bias -> fused output transform
    """

    def __init__(self, params):
        self.params = params
        self.layers = {}

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        p = self.params[name]
        mul, bias = L.fold_batch_norm(p["bn"])
        kernel = np.asarray(p["kernel"], np.float32) * mul
        self.layers[name] = {
            "kind": "conv", "kernel": kernel.astype(np.float32),
            "bias": bias, "stride": _pair(stride), "padding": padding,
            "activation": activation, "groups": groups,
            "dilation": _pair(dilation),
        }
        return L.batch_norm(
            L.conv2d(x, torch.as_tensor(p["kernel"]), _pair(stride), padding,
                     groups=groups, dilation=_pair(dilation)),
            _on(p["bn"], x))

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        p = self.params[name]
        mul, bias = L.fold_batch_norm(p["bn"])
        kernel = np.asarray(p["kernel"], np.float32) * mul.reshape(1, 1, -1, 1)
        self.layers[name] = {
            "kind": "depthwise_conv", "kernel": kernel.astype(np.float32),
            "bias": bias, "stride": _pair(stride), "activation": activation,
        }
        return L.batch_norm(
            L.depthwise_conv2d(x, torch.as_tensor(p["kernel"]),
                               _pair(stride)), _on(p["bn"], x))

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1):
        p = self.params[name]
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
        self.layers[name] = {
            "kind": "dense",
            "kernel": np.asarray(p["kernel"], np.float32),
            "bias": np.asarray(p["bias"], np.float32) if use_bias else None,
            "activation": activation,
        }
        y = L.dense(x, torch.as_tensor(p["kernel"]),
                    torch.as_tensor(p["bias"]).to(x.device)
                    if use_bias else None)
        return L.apply_activation(y, activation)


class _BinaryStream:
    """Lazily materialised output of a binary layer (packed domain).

    LCE decides statically whether a binary op's output is consumed packed
    (the next op is binary: write bitpacked words through thresholds,
    ``bitpack_activations_patterns.td:20-60``) or dense. Builders trace
    forward without lookahead, so the decision is made at the consumer: a
    binary layer returns this wrapper, and the representation the consumer
    pulls is the one that runs (memoised, so one consumer runs one conv).
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


class _DeferredBConv:
    """A float-output binary conv whose execution waits for its consumer.

    QuickNet's hot loop is ``x = add(x, binary_conv_bn(x, ...))``. When the
    consumer is that residual add, the whole block runs as one fused kernel
    call. Any other consumer calls ``materialize()``: before the fused add it
    runs the same kernel without the add; after it, it returns
    ``fused - x``, as the JAX package does, rather than a second conv that
    could differ from the fused one by a rounding.
    """

    def __init__(self, x, packed_filter, transform, params, block,
                 unpacked_filter):
        self.x = x
        self._args = (packed_filter, transform, params)
        self._block = block
        self._unpacked = unpacked_filter
        self._value = None
        self._fused = None

    def materialize(self):
        if self._value is None:
            if self._fused is not None:
                self._value = self._fused - self.x.to(self._fused.dtype)
            else:
                self._value = self._block(self.x, *self._args,
                                          has_residual=False,
                                          unpacked_filter=self._unpacked)
        return self._value

    def fuses_with(self, other):
        """True when ``add(other, self)`` is this conv's own residual add."""
        return other is self.x and self._value is None

    def fused_add(self):
        if self._fused is None:
            self._fused = self._block(self.x, *self._args, has_residual=True,
                                      unpacked_filter=self._unpacked)
        return self._fused


class PackedBuilder(_Base):
    """Packed inference forward over runtime layers.

    Float layers take their input in ``compute_dtype``, accumulate in
    float32, and store their output in ``compute_dtype`` (bf16 by default:
    the activation stream between layers). ``return_logits`` makes the final
    softmax the identity.

    ``domain="float"``: every 3x3 stride-1 one-padded binary conv goes
    through ``residual_block``, fused with its residual add when that is its
    consumer; every other binary conv runs ``quantize`` -> ``bconv2d_bgemm``
    and every binary dense ``quantize`` -> ``bgemm``, as JAX's
    ``kernel="bgemm"`` does.

    ``domain="packed"``: binary layers chain through bitpacked activations
    (convert-time thresholds and sign-flipped filters), pooling and flatten
    stay packed between them, and non-binary consumers pull the float view.
    An artifact without thresholds runs in the float domain.

    ``residual_block`` and ``gemm`` pick between kernel and plain version by
    the tensor's device; the plain versions may be passed to run them on the
    card for comparison.
    """

    def __init__(self, layers, compute_dtype=torch.bfloat16,
                 return_logits=False, residual_block=binary_residual_block,
                 gemm=bgemm, domain="float"):
        if domain not in ("float", "packed"):
            raise ValueError(f"unknown domain {domain!r}")
        self.layers = layers
        self.compute_dtype = compute_dtype
        self.return_logits = return_logits
        self.residual_block = residual_block
        self.gemm = gemm
        self.domain = domain

    def _f(self, x):
        """The float view of a deferred conv or a binary stream."""
        if isinstance(x, _DeferredBConv):
            return x.materialize()
        if isinstance(x, _BinaryStream):
            return x.to_float()
        return x

    def _store(self, y):
        """Materialise an inter-layer activation in the compute dtype."""
        return y.to(self.compute_dtype)

    def max_pool(self, x, pool_size, stride=None, padding="SAME"):
        if isinstance(x, _BinaryStream):
            # sign is monotonic, so max commutes with it: pooling the packed
            # words (bitwise AND) equals sign(float max pool).
            ps = _pair(pool_size)
            st = _pair(stride) if stride is not None else ps
            pad = Padding.SAME if padding == "SAME" else Padding.VALID
            return _BinaryStream(
                lambda: bmaxpool2d(x.packed(), ps, st, pad),
                lambda: super(PackedBuilder, self).max_pool(
                    x.to_float(), pool_size, stride, padding),
                x.channels)
        return super().max_pool(self._f(x), pool_size, stride, padding)

    def avg_pool(self, x, *a, **kw):
        return super().avg_pool(self._f(x), *a, **kw)

    def flatten(self, x):
        if isinstance(x, _BinaryStream) and x.channels % 32 == 0:
            # Exact only when no padding bits would interleave into the
            # flattened word stream.
            return _BinaryStream(
                lambda: x.packed().reshape(x.packed().shape[0], -1),
                lambda: super(PackedBuilder, self).flatten(x.to_float()),
                -1)
        return super().flatten(self._f(x))

    def global_avg_pool(self, x):
        return super().global_avg_pool(self._f(x))

    def add(self, a, b):
        for u, v in ((a, b), (b, a)):
            if isinstance(v, _DeferredBConv) and v.fuses_with(u):
                return v.fused_add()
        return super().add(self._f(a), self._f(b))

    def concat(self, xs):
        return super().concat([self._f(x) for x in xs])

    def activation(self, x, kind):
        return super().activation(self._f(x), kind)

    def softmax(self, x):
        x = self._f(x)
        if self.return_logits:
            return x.to(torch.float32)
        return super().softmax(x)

    def conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                activation=None, name, groups=1, dilation=1):
        a = self.layers[name]
        y = L.conv2d(self._f(x).to(self.compute_dtype), a["kernel"],
                     _pair(stride), padding, groups=groups,
                     dilation=_pair(dilation))
        y = y + a["bias"]
        return self._store(L.apply_activation(y, activation))

    def depthwise_conv_bn(self, x, ksize, *, stride=1, activation=None,
                          name):
        a = self.layers[name]
        y = L.depthwise_conv2d(self._f(x).to(self.compute_dtype), a["kernel"],
                               _pair(stride))
        y = y + a["bias"]
        return self._store(L.apply_activation(y, activation))

    def _packed_in(self, x):
        """A function giving the packed words of a binary layer's input."""
        if isinstance(x, _BinaryStream):
            return x.packed
        x = self._f(x)
        return lambda: quantize(x)

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1):
        a = self.layers[name]
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
        if self.domain == "packed" and "thresholds" in a:
            packed_in = self._packed_in(x)
            return _BinaryStream(
                lambda: bconv2d(
                    packed_in(), a["packed_filter_flipped"],
                    OutputTransform(thresholds=a["thresholds"]), params,
                    output_kind="bitpacked", gemm=self.gemm),
                lambda: self._store(bconv2d(
                    packed_in(), pf, transform, params, output_kind="float",
                    gemm=self.gemm)),
                filters)

        x = self._f(x)
        upf = a.get("filter_pm1")
        kh, kw = _pair(ksize)
        if residual_block_supported(x.shape, params, filters, kh, kw,
                                    has_residual=False):
            if x.shape[-1] == filters:
                return _DeferredBConv(x, pf, transform, params,
                                      self.residual_block, upf)
            return self._store(self.residual_block(
                x, pf, transform, params, has_residual=False,
                unpacked_filter=upf))
        return self._store(bconv2d(quantize(x), pf, transform, params,
                                   output_kind="float", gemm=self.gemm))

    def binary_dense_bn(self, x, units, *, name):
        a = self.layers[name]
        float_out = dict(multiplier=a["multiplier"], bias=a["bias"],
                         clamp_min=int(a["clamp_min"]),
                         clamp_max=int(a["clamp_max"]), out_kind="float")
        if self.domain == "packed" and "thresholds" in a:
            packed_in = self._packed_in(x)
            return _BinaryStream(
                lambda: self.gemm(packed_in(), a["packed_kernel_flipped"].t(),
                                  thresholds=a["thresholds"],
                                  out_kind="bitpacked"),
                lambda: self._store(self.gemm(
                    packed_in(), a["packed_kernel"].t(), **float_out)),
                units)
        lhs = quantize(self._f(x))  # (M, Cp)
        return self._store(self.gemm(lhs, a["packed_kernel"].t(), **float_out))

    def dense(self, x, units, *, use_bias=True, activation=None, name):
        a = self.layers[name]
        y = L.dense(self._f(x).to(self.compute_dtype), a["kernel"])
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


def convert_model(spec, params):
    """Float params -> packed artifact layer dict (numpy, as on disk)."""
    b = ConvertBuilder(params)
    _trace(spec, b)
    return b.layers


def prepare_runtime_arrays(layers):
    """Add once-unpacked +-1 int8 filters to artifact layers (numpy):

      bconv:  ``filter_pm1`` (FH, FW, C, O)
      bdense: ``kernel_pm1`` (C, units)

    The plain versions contract these; the CUDA kernel reads the packed
    words themselves.
    """
    def unpack(words, channels):
        w = torch.from_numpy(np.array(words, order="C").view(np.int32))
        return bitunpack(w, channels, dtype=torch.int8).numpy()

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
        out[name] = a
    return out


def packed_apply(spec, layers, x, compute_dtype=torch.bfloat16,
                 return_logits=False, device="cuda",
                 residual_block=binary_residual_block, gemm=bgemm,
                 domain="float"):
    """Packed inference forward on ``device`` (the card by default).

    ``layers`` are artifact layers (numpy) or runtime layers (tensors).
    ``domain="packed"`` chains binary layers through bitpacked activations
    (see ``PackedBuilder``); a model that ends on a binary layer then returns
    its packed words. ``residual_block`` and ``gemm`` may be
    ``binary_residual_block_plain`` and ``bgemm_plain`` to run the plain
    versions on the card for comparison.
    """
    device = resolve_device(device)
    layers = layers_from_numpy(layers, device)
    x = torch.as_tensor(x).to(device)
    builder = PackedBuilder(layers, compute_dtype=compute_dtype,
                            return_logits=return_logits,
                            residual_block=residual_block, gemm=gemm,
                            domain=domain)
    with torch.inference_mode():
        out = spec.forward(builder, x)
        if isinstance(out, _BinaryStream):
            out = out.packed()
        elif isinstance(out, _DeferredBConv):
            out = out.materialize()
    return out
