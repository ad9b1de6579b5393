"""Import Keras/Larq model weights into the port's parameter tree.

A copy of ``compute_engine_tpu.converter.keras_import`` (numpy and Keras
introspection); only ``params_structure`` differs, tracing shapes on torch's
meta device. Counterpart of LCE's ``convert_keras_model``
(`mlir/python/converter.py:166-280`): where the reference traces the Keras
graph through MLIR and pattern-matches binarisation ops, we map the Keras
weight *tree* onto the already-explicit architecture definition
(models.zoo). Matching is structural: the ordered sequence of parametric
Keras layers (Conv2D / QuantConv2D / DepthwiseConv2D / Dense, each with an
optional following BatchNormalization) must line up with the builder's layer
order — a mismatch raises with both sequences, rather than silently
mis-assigning weights.

TensorFlow is imported lazily; larq itself is NOT required (QuantConv2D is
recognised by class name), so this works in environments that only have the
checkpoint.
"""

from __future__ import annotations

import numpy as np

from ..models.builder import init_model
from ..models.zoo import ModelSpec

__all__ = ["import_keras_weights", "params_structure"]

_CONV_CLASSES = {"Conv2D", "QuantConv2D"}
_DW_CLASSES = {"DepthwiseConv2D", "QuantDepthwiseConv2D"}
_DENSE_CLASSES = {"Dense", "QuantDense"}
_BN_CLASSES = {"BatchNormalization"}


def params_structure(spec: ModelSpec, seed=0):
    """Ordered (name -> kind/shape) description of the model's parameters:
    numpy templates of the shapes ``init_model`` gives, traced on the meta
    device (no activation math runs)."""
    return {name: _numpy_tree(entry)
            for name, entry in init_model(spec, seed=seed).items()}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _keras_parametric_layers(model):
    """Flatten nested Keras layers into an ordered parametric sequence."""
    out = []
    for layer in model.layers:
        if hasattr(layer, "layers") and layer.layers:
            out.extend(_keras_parametric_layers(layer))
            continue
        cls = type(layer).__name__
        if cls in (_CONV_CLASSES | _DW_CLASSES | _DENSE_CLASSES
                   | _BN_CLASSES):
            out.append((cls, layer))
    return out


def _bn_params(layer):
    w = layer.get_weights()
    if len(w) != 4:
        raise ValueError(
            f"BatchNormalization {layer.name} must have 4 weights "
            "(gamma, beta, moving_mean, moving_variance)")
    return {
        "gamma": np.asarray(w[0], np.float32),
        "beta": np.asarray(w[1], np.float32),
        "moving_mean": np.asarray(w[2], np.float32),
        "moving_variance": np.asarray(w[3], np.float32),
    }


def import_keras_weights(keras_model, spec: ModelSpec):
    """Map a Keras/Larq model's weights onto ``spec``'s parameter tree.

    Returns a params dict usable with ``models.float_apply`` /
    ``converter.convert``.
    """
    ours = params_structure(spec)
    seq = _keras_parametric_layers(keras_model)

    # Pair each BatchNormalization with the layer that PRODUCES its input,
    # via the functional graph (Keras orders `model.layers` topologically by
    # depth, so parallel branches interleave convs and BNs — sequence
    # adjacency is not a valid pairing rule).
    bn_for = {}
    for cls, layer in seq:
        if cls not in _BN_CLASSES:
            continue
        producer = getattr(layer.input, "_keras_history", None)
        producer = producer[0] if producer is not None else None
        if (producer is None
                or type(producer).__name__ not in
                (_CONV_CLASSES | _DW_CLASSES | _DENSE_CLASSES)
                or id(producer) in bn_for):
            raise ValueError(
                f"unexpected BatchNormalization {layer.name} without a "
                "producing conv/dense layer")
        bn_for[id(producer)] = layer

    grouped = [(cls, layer, bn_for.get(id(layer)))
               for cls, layer in seq if cls not in _BN_CLASSES]

    our_items = list(ours.items())
    if len(grouped) != len(our_items):
        raise ValueError(
            f"layer count mismatch: keras has {len(grouped)} parametric "
            f"layers {[l.name for _, l, _ in grouped]}, model spec has "
            f"{len(our_items)} {[n for n, _ in our_items]}")

    params = {}
    for (cls, layer, bn), (name, template) in zip(grouped, our_items):
        weights = layer.get_weights()
        kernel = np.asarray(weights[0], np.float32)
        expects_bn = "bn" in template
        if expects_bn != (bn is not None):
            raise ValueError(
                f"BN mismatch at {name} (keras layer {layer.name}): "
                f"spec {'expects' if expects_bn else 'does not expect'} BN")
        if kernel.shape != template["kernel"].shape:
            raise ValueError(
                f"kernel shape mismatch at {name} (keras {layer.name}): "
                f"{kernel.shape} vs {template['kernel'].shape}")
        entry = {"kernel": kernel}
        if bn is not None:
            entry["bn"] = _bn_params(bn)
        if "bias" in template:
            if len(weights) < 2:
                raise ValueError(f"{name}: spec expects a bias, keras layer "
                                 f"{layer.name} has none")
            entry["bias"] = np.asarray(weights[1], np.float32)
        params[name] = entry
    return params
