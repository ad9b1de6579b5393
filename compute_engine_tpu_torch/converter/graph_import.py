"""Generic Keras functional-graph importer: graph -> (ModelSpec, params).

The reference converts *arbitrary* Larq Keras graphs by MLIR pattern
matching (`mlir/python/converter.py:166-280` drives the pipeline;
`mlir/transforms/prepare_patterns_common.td:26-127` recognises the
``ste_sign`` select patterns and the PadV2(+1)+VALID-conv one-padding
idiom). This module is the port's equivalent, a copy of
``compute_engine_tpu.converter.graph_import`` (numpy and Keras
introspection only, so nothing but its imports differs): it walks a Keras
functional graph directly and emits builder calls (models.builder), so a
zoo-shaped model no longer needs a hand-written ModelSpec —
``import_keras_model(model)`` returns a spec whose forward replays the
graph plus the parameter tree extracted from the layers.

The walk produces a declarative **graph program** — a JSON-serializable
list of builder-op records — which is what the returned spec replays
(``spec.forward.program``). Stored in an artifact header it makes the
artifact fully self-contained, like the reference's flatbuffer carrying
the op graph next to the packed weights: ``spec_from_program`` rebuilds
the ModelSpec with no Python model definition present.

Binarisation and one-padding are recognised *behaviourally*: an unknown
single-input layer (e.g. a ``Lambda`` wrapping ``tf.where(x<0,-1,1)`` or
``tf.pad(..., constant_values=1)``) is probed with a small deterministic
tensor and classified by what it computes — sign, constant-pad, or
identity — which is strictly more robust than matching source patterns
and covers both the larq idioms and hand-rolled twins.

Supported layer vocabulary (the reference pipeline's effective coverage,
`prepare_patterns_common.td` + `optimize_patterns_common.td`): Conv2D /
DepthwiseConv2D / Dense (+ larq Quant* variants by class name), each fused
with its following BatchNormalization, including grouped and dilated convs
(`prepare_tf.cc:121-146` grouped validation, `:172` dilated recomposition);
MaxPooling2D / AveragePooling2D / GlobalAveragePooling2D; Add /
Concatenate; Flatten / Reshape-to-flat; Activation / ReLU / Softmax;
ZeroPadding2D; Dropout (identity); per-tensor fake-quant layers, whose QAT
ranges are absorbed into the program (`mlir/transforms/quantize.cc:15-42`
— see :func:`graph_int8_ranges`). A plain Conv2D/Dense consuming a
binarised tensor must carry an effectively binary (+-scale) kernel; the
scale folds into the BN (``IsBinaryFilter``, `prepare_tf.cc:66-90`).
Anything else raises with the layer named, like the reference's
``allow_custom_ops``-off conversion failure mode.

TensorFlow is imported lazily; larq itself is NOT required (QuantConv2D /
QuantDense are recognised by class name, their internal input quantizer
assumed to be ste_sign — larq's default and the only quantizer the
reference's PrepareLCE pattern accepts).
"""

from __future__ import annotations

import numpy as np

from ..core.params import tflite_same_padding
from ..models.zoo import ModelSpec

__all__ = ["import_keras_model", "spec_from_program", "graph_int8_ranges",
           "GraphImportError"]

_CONV = {"Conv2D"}
_QCONV = {"QuantConv2D"}
_DW = {"DepthwiseConv2D"}
_QDW = {"QuantDepthwiseConv2D"}
_DENSE = {"Dense"}
_QDENSE = {"QuantDense"}
_BN = {"BatchNormalization"}
_IDENTITY = {"Dropout", "SpatialDropout2D", "ActivityRegularization"}

# Builder methods a graph program may invoke (replay whitelist).
_PROGRAM_OPS = {
    "conv_bn", "depthwise_conv_bn", "binary_conv_bn", "binary_dense_bn",
    "dense", "max_pool", "avg_pool", "global_avg_pool", "add", "concat",
    "flatten", "activation", "softmax",
}


class GraphImportError(ValueError):
    pass


class _Val:
    """A symbolic value flowing through the walk.

    ``sym``: SSA id into the replay environment (the PRE-binarisation
    tensor — builder binary ops apply ste_sign themselves).
    ``binarized``: a sign layer was applied; must be consumed by a binary
    conv/dense (or a pad feeding one).
    ``pad``: pending explicit constant pad (pt, pb, pl, pr, value) to be
    folded into the consuming conv's padding, like the reference's
    FusePadding / PadV2(+1) patterns.
    ``fq``: pending fake-quant range (min, max) absorbed from the graph —
    the consuming int8-capable layer records it as its input range, the
    analogue of LCEQuantizePass absorbing quantize/dequantize pairs
    (`mlir/transforms/quantize.cc:15-42`).
    """

    def __init__(self, sym, binarized=False, pad=None, fq=None):
        self.sym = sym
        self.binarized = binarized
        self.pad = pad
        self.fq = fq


def _single(xs):
    return xs[0] if isinstance(xs, (list, tuple)) else xs


def _layer_node(layer):
    nodes = getattr(layer, "_inbound_nodes", None) or []
    if len(nodes) != 1:
        raise GraphImportError(
            f"layer {layer.name} has {len(nodes)} call nodes; shared/"
            "multi-call layers are not supported (call the model builder "
            "directly for weight-tied architectures)")
    return nodes[0]


def _probe_classify(layer, in_shape):
    """Run ``layer`` on a deterministic probe and classify its behaviour.

    Returns ("sign",), ("pad", pt, pb, pl, pr, value), ("identity",) or
    None (unrecognised).
    """
    import tensorflow as tf

    shape = [1 if d is None else int(d) for d in in_shape]
    rng = np.random.default_rng(0)
    probe = (rng.uniform(1.5, 2.5, shape)
             * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    try:
        out = np.asarray(layer(tf.constant(probe)))
    except Exception:
        return None
    if out.shape == probe.shape:
        if np.array_equal(out, np.where(probe < 0, -1.0, 1.0)):
            return ("sign",)
        if np.array_equal(out, probe):
            return ("identity",)
        return _classify_fakequant(layer, shape)
    if out.ndim == probe.ndim == 4 and out.shape[0] == probe.shape[0] \
            and out.shape[3] == probe.shape[3] \
            and out.shape[1] >= probe.shape[1] \
            and out.shape[2] >= probe.shape[2]:
        # Candidate constant pad: find the interior offset.
        dh = out.shape[1] - probe.shape[1]
        dw = out.shape[2] - probe.shape[2]
        for pt in range(dh + 1):
            for pl in range(dw + 1):
                interior = out[:, pt:pt + probe.shape[1],
                               pl:pl + probe.shape[2], :]
                if not np.array_equal(interior, probe):
                    continue
                mask = np.ones(out.shape, bool)
                mask[:, pt:pt + probe.shape[1], pl:pl + probe.shape[2],
                     :] = False
                border = out[mask]
                if border.size == 0:
                    return ("pad", 0, 0, 0, 0, 0.0)
                v = border.flat[0]
                if np.all(border == v) and float(v) in (0.0, 1.0):
                    return ("pad", pt, dh - pt, pl, dw - pl, float(v))
        return None
    return None


def _classify_fakequant(layer, shape):
    """Detect a per-tensor fake-quant layer behaviourally.

    A QAT graph carries fake-quant ops (e.g. a Lambda wrapping
    ``tf.quantization.fake_quant_with_min_max_args``) whose declared range
    the converter must absorb (the reference's LCEQuantizePass reads int8
    quantize/dequantize pairs from the graph, `mlir/transforms/quantize.cc:
    15-42`, `quantize_patterns.td:6-77`). The probe: a wide symmetric ramp
    exposes the clamp bounds; in-range outputs must sit on the uniform
    8-bit grid between them and stay within half a step of the input.
    Returns ("fakequant", min, max) or None.
    """
    import tensorflow as tf

    n = int(np.prod(shape))
    ramp = np.concatenate([
        -np.geomspace(1e4, 1e-3, n // 2 + 1), [0.0],
        np.geomspace(1e-3, 1e4, n - n // 2 - 1)]) if n > 3 else \
        np.linspace(-1e4, 1e4, n)
    ramp = ramp[:n].astype(np.float32).reshape(shape)
    try:
        out = np.asarray(layer(tf.constant(ramp)))
    except Exception:
        return None
    if out.shape != ramp.shape:
        return None
    mn, mx = float(out.min()), float(out.max())
    if not (mn <= 0.0 <= mx) or mx - mn <= 0:
        return None
    # 8-bit grid (255 steps, TF fake_quant default num_bits=8).
    step = (mx - mn) / 255.0
    on_grid = np.abs((out - mn) / step
                     - np.round((out - mn) / step)) < 1e-3
    # In-range inputs must round to within half a step; out-of-range clamp.
    clamped = np.clip(ramp, mn, mx)
    close = np.abs(out - clamped) <= step * 0.5001 + 1e-6
    if bool(np.all(on_grid)) and bool(np.all(close)):
        return ("fakequant", mn, mx)
    return None


def _verify_binary_kernel(kernel, layer_name):
    """A plain (non-Quant*) conv/dense treated as binary must carry an
    effectively binary kernel: every entry +-scale, scale per output
    channel, within the reference's 0.5% tolerance (``IsBinaryFilter``,
    `prepare_tf.cc:66-90`). Returns the per-channel |scale| vector.

    Without this check, a model with binary activations but real-valued
    weights (larq input_quantizer without kernel_quantizer — a graph the
    reference's PrepareLCE would NOT convert) would import "successfully"
    and silently sign-binarise the kernel.
    """
    a = np.abs(np.asarray(kernel, np.float32))
    reduce_axes = tuple(range(kernel.ndim - 1))
    scale = a.mean(axis=reduce_axes)
    if np.any(scale <= 0) or \
            float(np.max(np.abs(a - scale) / np.maximum(scale, 1e-30))) \
            > 0.005:
        raise GraphImportError(
            f"{layer_name}: consumes a binarised tensor but its kernel is "
            "not binary (entries must be +-scale per output channel within "
            "0.5%, the reference's IsBinaryFilter rule `prepare_tf.cc:"
            "66-90`) — a float-weight conv on binary activations is not "
            "representable")
    return scale.astype(np.float32)


def _fold_kernel_scale(kernel, bn, scale):
    """Fold a per-channel binary-kernel |scale| into the following BN.

    The original graph computes BN(scale_c * (sign(w) * sign(x))); dividing
    the kernel by scale (making it +-1 latent) while scaling gamma and
    moving_mean keeps the replayed forward identical:
    BN'(t) with gamma' = gamma*scale, mean' = mean/scale equals BN(scale*t).
    This is how the reference moves the filter scale into the
    post_activation_multiplier (`prepare_patterns_common.td:97-127`).
    """
    if np.allclose(scale, 1.0, rtol=1e-6, atol=1e-7):
        return kernel, bn
    kernel = (np.asarray(kernel, np.float32) / scale).astype(np.float32)
    bn = dict(bn)
    bn["gamma"] = (bn["gamma"] * scale).astype(np.float32)
    bn["moving_mean"] = (bn["moving_mean"] / scale).astype(np.float32)
    return kernel, bn


def _bn_params(layer):
    w = layer.get_weights()
    if len(w) != 4:
        raise GraphImportError(
            f"BatchNormalization {layer.name}: expected 4 weights "
            "(gamma, beta, moving_mean, moving_variance), got "
            f"{len(w)} — center/scale must both be enabled")
    return {"gamma": np.asarray(w[0], np.float32),
            "beta": np.asarray(w[1], np.float32),
            "moving_mean": np.asarray(w[2], np.float32),
            "moving_variance": np.asarray(w[3], np.float32)}


def _cfg(layer):
    return layer.get_config()


def _pairc(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _resolve_conv_padding(layer, val, in_hw, ksize, stride, dilation=(1, 1)):
    """Fold an explicit pad (if pending) into SAME/VALID + pad_value.

    Mirrors the reference's FusePadding pass and the PadV2(+1)+VALID
    one-padding pattern (`prepare_patterns_common.td:136-168`): an explicit
    pad is only representable when it equals the TFLite SAME amounts for
    this filter/stride, in which case the conv becomes SAME with the pad's
    constant as pad_value.

    ``in_hw`` is the conv's Keras input shape — i.e. the PADDED tensor when
    a pad is pending. The SAME amounts must be computed on the PRE-pad
    shape the emitted SAME conv will actually run on (using
    the padded dims silently diverges for strided convs on odd
    extents and falsely rejects representable pads).
    """
    cfg_padding = _cfg(layer)["padding"].upper()
    if val.pad is None:
        return cfg_padding, (0 if cfg_padding == "SAME" else 1), val.sym
    pt, pb, pl, pr, value = val.pad
    if cfg_padding != "VALID":
        raise GraphImportError(
            f"{layer.name}: explicit pad feeding a {cfg_padding}-padded "
            "conv cannot be folded (reference folds pad+VALID only)")
    pre_h = in_hw[0] - pt - pb
    pre_w = in_hw[1] - pl - pr
    _, wt, wb = tflite_same_padding(pre_h, ksize[0], stride[0], dilation[0])
    _, wl, wr = tflite_same_padding(pre_w, ksize[1], stride[1], dilation[1])
    if (pt, pb, pl, pr) != (wt, wb, wl, wr):
        raise GraphImportError(
            f"{layer.name}: explicit pad ({pt},{pb},{pl},{pr}) does not "
            f"match the SAME amounts ({wt},{wb},{wl},{wr}) for filter "
            f"{ksize} stride {stride} on the pre-pad input {pre_h}x{pre_w}; "
            "general constant pads are not representable (same restriction "
            "as the reference's FusePadding pass)")
    return "SAME", int(value), val.sym


def _program_forward(program, out_sym, extra=None):
    """Build a builder-replaying forward from a declarative program."""

    def forward(b, x):
        env = {0: x}
        for rec in program:
            op, ins, kw = rec["op"], rec["in"], dict(rec.get("kw", {}))
            if op not in _PROGRAM_OPS:
                raise GraphImportError(f"unknown program op {op!r}")
            args = [env[s] for s in ins]
            if op == "concat":
                env[rec["out"]] = b.concat(args)
            else:
                env[rec["out"]] = getattr(b, op)(*args, **kw)
        return env[out_sym]

    forward.program = {"ops": program, "out": out_sym, **(extra or {})}
    return forward


def spec_from_program(graph_program, *, input_size, num_classes,
                      name="imported"):
    """Rebuild a ModelSpec from a serialized graph program.

    ``graph_program`` is the JSON structure produced by
    ``import_keras_model`` (``spec.forward.program``) — typically stored
    in an artifact header (``config["graph_program"]``), which makes the
    artifact fully self-contained: model structure + packed weights, the
    flatbuffer analogue. Absorbed QAT ranges (``int8_ranges`` /
    ``int8_out_ranges``) ride along and are readable via
    :func:`graph_int8_ranges`.
    """
    extra = {k: graph_program[k]
             for k in ("int8_ranges", "int8_out_ranges")
             if graph_program.get(k)}
    forward = _program_forward(graph_program["ops"], graph_program["out"],
                               extra)
    return ModelSpec(name, forward, input_size=tuple(input_size),
                     num_classes=num_classes)


def graph_int8_ranges(spec):
    """(int8_ranges, int8_out_ranges) absorbed from the imported graph.

    Pass these straight to ``convert_model(spec, params,
    int8_ranges=..., int8_out_ranges=...)`` — the converter then needs no
    side-channel calibration for a QAT graph, matching the reference's
    LCEQuantizePass reading quantizer ranges from the model itself
    (`mlir/transforms/quantize.cc:15-42`)."""
    program = getattr(spec.forward, "program", {}) or {}
    return (dict(program.get("int8_ranges", {})),
            dict(program.get("int8_out_ranges", {})))


def import_keras_model(model, name=None):
    """Walk a Keras functional model and return ``(ModelSpec, params)``.

    The returned spec's forward replays the recorded graph program through
    any builder (Float/Convert/Packed/...), and ``params`` is the extracted
    parameter tree — together a drop-in for a hand-written zoo ModelSpec,
    validated by re-importing the Keras golden twins without their specs
    (tests/test_graph_import.py). The serializable program is available as
    ``spec.forward.program``.
    """
    if len(getattr(model, "inputs", []) or []) != 1 or \
            len(getattr(model, "outputs", []) or []) != 1:
        raise GraphImportError(
            "only single-input single-output functional models are "
            "supported")

    in_shape = tuple(model.inputs[0].shape)
    if len(in_shape) != 4:
        raise GraphImportError(f"expected NHWC image input, got {in_shape}")

    # tensor-name -> _Val; consumer map for conv+BN fusion.
    consumers: dict[str, list] = {}
    for layer in model.layers:
        if hasattr(layer, "layers") and getattr(layer, "layers", None):
            raise GraphImportError(
                f"nested sub-model {layer.name} — flatten the model first")
        node = _layer_node(layer)
        for t in (node.input_tensors or []):
            consumers.setdefault(t.name, []).append(layer)

    values: dict[str, _Val] = {}
    program: list = []       # declarative op records (sym 0 = model input)
    params: dict = {}
    merged_bn: set = set()   # BN layers fused into their producing conv
    next_sym = [0]
    producer: dict = {}      # sym -> producing layer name (for QAT ranges)
    in_ranges: dict = {}     # absorbed fake-quant ranges (abs-max), keyed
    out_ranges: dict = {}    # by consuming / producing layer name

    def emit(op, ins, **kw):
        next_sym[0] += 1
        program.append({"op": op, "in": list(ins), "out": next_sym[0],
                        "kw": kw})
        return next_sym[0]

    def in_vals(node):
        return [values[t.name] for t in node.input_tensors]

    def plain_input(val, layer):
        if val.binarized or val.pad is not None:
            raise GraphImportError(
                f"{layer.name}: a {'binarised' if val.binarized else 'padded'}"
                " tensor may only feed a binary conv/dense (reference "
                "PrepareLCE accepts no other consumer of ste_sign)")
        return val

    def following_bn(layer, out_tensor):
        cons = consumers.get(out_tensor.name, [])
        if len(cons) == 1 and type(cons[0]).__name__ in _BN:
            return cons[0]
        return None

    def uname(layer):
        if layer.name in params:
            raise GraphImportError(f"duplicate layer name {layer.name}")
        return layer.name

    for layer in model.layers:
        cls = type(layer).__name__
        node = _layer_node(layer)
        out_t = _single(node.output_tensors)

        if cls == "InputLayer":
            values[out_t.name] = _Val(0)  # sym 0 = the model input
            continue
        if cls in _BN:
            if layer in merged_bn:
                values[out_t.name] = values[_single(node.input_tensors).name]
                continue
            raise GraphImportError(
                f"standalone BatchNormalization {layer.name} (not directly "
                "after a conv/dense) is not representable")
        if cls in _IDENTITY:
            values[out_t.name] = in_vals(node)[0]
            continue

        if cls in (_CONV | _QCONV | _DW | _QDW):
            (val,) = in_vals(node)
            cfg = _cfg(layer)
            if cfg.get("use_bias"):
                raise GraphImportError(
                    f"{layer.name}: conv bias is not supported — zoo convs "
                    "are bias-free into BatchNorm")
            if cfg.get("activation", "linear") != "linear":
                raise GraphImportError(
                    f"{layer.name}: fused conv activation is not supported; "
                    "use a separate Activation layer after the BN")
            dilation = _pairc(cfg.get("dilation_rate", 1))
            groups = int(cfg.get("groups", 1)) if cls in _CONV | _QCONV else 1
            bn = following_bn(layer, out_t)
            if bn is None:
                raise GraphImportError(
                    f"{layer.name}: conv without a following "
                    "BatchNormalization is not representable")
            merged_bn.add(bn)
            ksize = _pairc(cfg["kernel_size"])
            stride = _pairc(cfg["strides"])
            in_hw = (int(_single(node.input_tensors).shape[1]),
                     int(_single(node.input_tensors).shape[2]))
            lname = uname(layer)
            kernel = np.asarray(layer.get_weights()[0], np.float32)
            bn_p = _bn_params(bn)
            is_binary = cls in _QCONV or val.binarized
            extra = {}
            if groups != 1:
                extra["groups"] = groups
            if dilation != (1, 1):
                extra["dilation"] = list(dilation)
            if cls in _DW | _QDW:
                if is_binary:
                    raise GraphImportError(
                        f"{layer.name}: binary depthwise conv TODO (the "
                        "reference has no binary depthwise op either)")
                plain_input(val, layer)
                if cfg["padding"].upper() != "SAME":
                    raise GraphImportError(
                        f"{layer.name}: depthwise conv supports SAME only")
                if dilation != (1, 1):
                    raise GraphImportError(
                        f"{layer.name}: dilated depthwise conv TODO")
                if val.fq is not None:
                    in_ranges[lname] = max(in_ranges.get(lname, 0.0), val.fq)
                params[lname] = {"kernel": kernel, "bn": bn_p}
                sym = emit("depthwise_conv_bn", [val.sym], ksize=list(ksize),
                           stride=list(stride), name=lname)
                producer[sym] = lname
                values[out_t.name] = _Val(sym)
                continue
            filters = int(cfg["filters"])
            if is_binary:
                padding, pad_value, sym_in = _resolve_conv_padding(
                    layer, val, in_hw, ksize, stride, dilation)
                if cls not in _QCONV:
                    # Plain Conv2D on a binarised tensor: its kernel is
                    # used as-is by the source model, so it must be
                    # effectively binary; a +-scale kernel folds into the
                    # BN (the reference's IsBinaryFilter + scale-to-
                    # post-multiplier rewrite).
                    scale = _verify_binary_kernel(kernel, layer.name)
                    kernel, bn_p = _fold_kernel_scale(kernel, bn_p, scale)
                params[lname] = {"kernel": kernel, "bn": bn_p}
                sym = emit("binary_conv_bn", [sym_in], filters=filters,
                           ksize=list(ksize), stride=list(stride),
                           padding=padding, pad_value=pad_value, name=lname,
                           **extra)
                producer[sym] = lname
                values[out_t.name] = _Val(sym)
            else:
                plain_input(val, layer)
                if val.fq is not None:
                    in_ranges[lname] = max(in_ranges.get(lname, 0.0), val.fq)
                params[lname] = {"kernel": kernel, "bn": bn_p}
                sym = emit("conv_bn", [val.sym], filters=filters,
                           ksize=list(ksize), stride=list(stride),
                           padding=cfg["padding"].upper(), name=lname,
                           **extra)
                producer[sym] = lname
                values[out_t.name] = _Val(sym)
            continue

        if cls in (_DENSE | _QDENSE):
            (val,) = in_vals(node)
            cfg = _cfg(layer)
            units = int(cfg["units"])
            lname = uname(layer)
            weights = layer.get_weights()
            is_binary = cls in _QDENSE or val.binarized
            bn = following_bn(layer, out_t)
            if is_binary:
                if cfg.get("use_bias"):
                    raise GraphImportError(
                        f"{layer.name}: binary dense must be bias-free")
                if bn is None:
                    raise GraphImportError(
                        f"{layer.name}: binary dense requires a following "
                        "BatchNormalization")
                merged_bn.add(bn)
                kernel = np.asarray(weights[0], np.float32)
                bn_p = _bn_params(bn)
                if cls not in _QDENSE:
                    # Same effective-binarity rule as plain Conv2D on a
                    # binarised tensor (per-unit +-scale, folded into BN).
                    scale = _verify_binary_kernel(kernel, layer.name)
                    kernel, bn_p = _fold_kernel_scale(kernel, bn_p, scale)
                params[lname] = {"kernel": kernel, "bn": bn_p}
                sym = emit("binary_dense_bn", [val.sym], units=units,
                           name=lname)
                producer[sym] = lname
                values[out_t.name] = _Val(sym)
            else:
                plain_input(val, layer)
                if val.fq is not None:
                    in_ranges[lname] = max(in_ranges.get(lname, 0.0), val.fq)
                if bn is not None:
                    raise GraphImportError(
                        f"{layer.name}: float dense + BN is not in the "
                        "builder vocabulary")
                use_bias = bool(cfg.get("use_bias", True))
                entry = {"kernel": np.asarray(weights[0], np.float32)}
                if use_bias:
                    entry["bias"] = np.asarray(weights[1], np.float32)
                params[lname] = entry
                act = cfg.get("activation", "linear")
                if act == "softmax":
                    sym = emit("dense", [val.sym], units=units,
                               use_bias=use_bias, name=lname)
                    producer[sym] = lname
                    values[out_t.name] = _Val(emit("softmax", [sym]))
                else:
                    sym = emit(
                        "dense", [val.sym], units=units, use_bias=use_bias,
                        activation=None if act == "linear" else act,
                        name=lname)
                    producer[sym] = lname
                    values[out_t.name] = _Val(sym)
            continue

        if cls == "MaxPooling2D" or cls == "AveragePooling2D":
            (val,) = in_vals(node)
            plain_input(val, layer)
            cfg = _cfg(layer)
            pool = _pairc(cfg["pool_size"])
            stride = _pairc(cfg["strides"] or cfg["pool_size"])
            meth = "max_pool" if cls == "MaxPooling2D" else "avg_pool"
            # Pooling is range-preserving (max) / range-bounded (avg), so a
            # pending fake-quant range keeps describing the pooled tensor —
            # the canonical QAT idiom fq -> pool -> conv must reach the
            # conv's in_range (silently dropping it left the
            # artifact only partially int8).
            values[out_t.name] = _Val(emit(
                meth, [val.sym], pool_size=list(pool), stride=list(stride),
                padding=cfg["padding"].upper()), fq=val.fq)
            continue
        if cls == "GlobalAveragePooling2D":
            (val,) = in_vals(node)
            plain_input(val, layer)
            if _cfg(layer).get("keepdims"):
                raise GraphImportError(f"{layer.name}: keepdims TODO")
            values[out_t.name] = _Val(emit("global_avg_pool", [val.sym]),
                                      fq=val.fq)
            continue
        if cls == "Add":
            vals = [plain_input(v, layer) for v in in_vals(node)]
            if len(vals) != 2:
                raise GraphImportError(f"{layer.name}: Add expects 2 inputs")
            values[out_t.name] = _Val(emit("add", [v.sym for v in vals]))
            continue
        if cls == "Concatenate":
            if _cfg(layer)["axis"] not in (-1, 3):
                raise GraphImportError(
                    f"{layer.name}: concat on non-channel axis")
            vals = [plain_input(v, layer) for v in in_vals(node)]
            values[out_t.name] = _Val(emit("concat", [v.sym for v in vals]))
            continue
        if cls == "Flatten":
            (val,) = in_vals(node)
            plain_input(val, layer)
            values[out_t.name] = _Val(emit("flatten", [val.sym]),
                                      fq=val.fq)
            continue
        if cls == "Reshape":
            (val,) = in_vals(node)
            plain_input(val, layer)
            tgt = tuple(_cfg(layer)["target_shape"])
            if len(tgt) != 1:
                raise GraphImportError(
                    f"{layer.name}: only flattening reshapes are supported")
            values[out_t.name] = _Val(emit("flatten", [val.sym]),
                                      fq=val.fq)
            continue
        if cls in ("Activation", "ReLU", "Softmax", "LeakyReLU"):
            (val,) = in_vals(node)
            plain_input(val, layer)
            if cls == "ReLU":
                kind = "relu"
            elif cls == "Softmax":
                kind = "softmax"
            elif cls == "LeakyReLU":
                raise GraphImportError(f"{layer.name}: leaky relu TODO")
            else:
                kind = _cfg(layer)["activation"]
            if kind == "softmax":
                values[out_t.name] = _Val(emit("softmax", [val.sym]))
            elif kind == "linear":
                values[out_t.name] = val
            else:
                values[out_t.name] = _Val(emit("activation", [val.sym],
                                               kind=kind))
            continue
        if cls == "ZeroPadding2D":
            (val,) = in_vals(node)
            ((pt, pb), (pl, pr)) = _cfg(layer)["padding"]
            if val.pad is not None:
                raise GraphImportError(f"{layer.name}: stacked pads")
            values[out_t.name] = _Val(val.sym, binarized=val.binarized,
                                      pad=(pt, pb, pl, pr, 0.0))
            continue

        # Unknown layer: behavioural probe (sign / constant pad / identity).
        node_in = node.input_tensors
        if len(node_in) == 1:
            verdict = _probe_classify(layer, tuple(node_in[0].shape))
            val = values[node_in[0].name]
            if verdict is not None and verdict[0] == "sign":
                if val.binarized or val.pad is not None:
                    raise GraphImportError(
                        f"{layer.name}: sign of a sign/padded tensor")
                values[out_t.name] = _Val(val.sym, binarized=True)
                continue
            if verdict is not None and verdict[0] == "pad":
                _, pt, pb, pl, pr, v = verdict
                if val.pad is not None:
                    raise GraphImportError(f"{layer.name}: stacked pads")
                values[out_t.name] = _Val(val.sym, binarized=val.binarized,
                                          pad=(pt, pb, pl, pr, v))
                continue
            if verdict is not None and verdict[0] == "identity":
                values[out_t.name] = val
                continue
            if verdict is not None and verdict[0] == "fakequant":
                # Absorb the graph's QAT range instead of requiring
                # API-side calibration (`mlir/transforms/quantize.cc:
                # 15-42`): the symmetric abs-max becomes the producing
                # layer's output range and the consuming layer's input
                # range; the op itself replays as identity (the packed
                # runtime re-quantises with this exact range).
                if val.binarized or val.pad is not None:
                    raise GraphImportError(
                        f"{layer.name}: fake-quant of a sign/padded tensor")
                _, mn, mx = verdict
                r = max(abs(mn), abs(mx))
                src = producer.get(val.sym)
                if src is not None:
                    out_ranges[src] = max(out_ranges.get(src, 0.0), r)
                values[out_t.name] = _Val(val.sym, fq=r)
                continue
        raise GraphImportError(
            f"unsupported layer {layer.name} ({cls}) — not in the importer "
            "vocabulary and not behaviourally a sign/pad/identity")

    out_val = values[model.outputs[0].name]
    if out_val.binarized or out_val.pad is not None:
        raise GraphImportError("model output is a pending sign/pad")

    graph_program = {"ops": program, "out": out_val.sym}
    if in_ranges:
        graph_program["int8_ranges"] = in_ranges
    if out_ranges:
        graph_program["int8_out_ranges"] = out_ranges
    spec = spec_from_program(
        graph_program,
        input_size=(int(in_shape[1]), int(in_shape[2])),
        num_classes=int(model.outputs[0].shape[-1]),
        name=name or getattr(model, "name", "imported"))
    return spec, params
