"""``import_keras_weights`` and ``params_structure`` of the port against the
JAX package's, on the Keras twin of tests/test_keras_import.py."""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

from compute_engine_tpu.converter import keras_import as jki  # noqa: E402
from compute_engine_tpu.models import float_apply as jfloat_apply  # noqa: E402
from compute_engine_tpu.models import get_model as jget_model  # noqa: E402
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec  # noqa: E402

from compute_engine_tpu_torch.converter.keras_import import (  # noqa: E402
    import_keras_weights, params_structure)
from compute_engine_tpu_torch.models import (convert_model,  # noqa: E402
                                             float_apply, get_model,
                                             packed_apply)
from compute_engine_tpu_torch.models.zoo import ModelSpec  # noqa: E402

import _torch_parity as parity  # noqa: E402
from test_keras_import import build_keras_twin, tiny_forward  # noqa: E402

JSPEC = JModelSpec("tiny_keras", tiny_forward, input_size=(32, 32),
                   num_classes=10)
SPEC = ModelSpec("tiny_keras", tiny_forward, input_size=(32, 32),
                 num_classes=10)


@pytest.fixture(scope="module")
def keras_model():
    return build_keras_twin(np.random.default_rng(42))


@pytest.mark.parametrize("model", ["tiny_keras", "quicknet",
                                   "binary_alexnet"])
def test_params_structure_equals_jax(model):
    """Traced on the meta device: numpy templates with JAX's names, order,
    shapes and (the rng is called in the same order) values."""
    spec, jspec = ((SPEC, JSPEC) if model == "tiny_keras"
                   else (get_model(model), jget_model(model)))
    got, want = params_structure(spec), jki.params_structure(jspec)
    assert list(got) == list(want)
    parity.assert_trees_equal(got, want)
    assert all(isinstance(v["kernel"], np.ndarray) for v in got.values())


def test_import_keras_weights_equals_jax(keras_model):
    got = import_keras_weights(keras_model, SPEC)
    want = jki.import_keras_weights(keras_model, JSPEC)
    assert list(got) == list(want) == ["stem", "block0", "head"]
    parity.assert_trees_equal(got, want)
    x = parity.images(1, 2)
    with torch.no_grad():
        y = float_apply(SPEC, got, x, device="cpu")
    parity.assert_outputs_close(y, jfloat_apply(JSPEC, want, jnp.asarray(x)),
                                **parity.FLOAT32_MODEL_TOL)
    # The Keras model itself, its latent binary kernel binarised.
    w = keras_model.get_layer("binary_conv").get_weights()[0]
    keras_model.get_layer("binary_conv").set_weights(
        [np.where(w < 0, -1.0, 1.0).astype(np.float32)])
    try:
        golden = keras_model(x, training=False).numpy()
    finally:
        keras_model.get_layer("binary_conv").set_weights([w])
    parity.assert_outputs_close(y, golden, atol=1e-4, rtol=1e-3)
    packed = packed_apply(SPEC, convert_model(SPEC, got), x,
                          compute_dtype=torch.float32, device="cpu")
    parity.assert_outputs_close(packed, golden, atol=1e-3, rtol=1e-2)


def _spec(forward):
    return ModelSpec("wrong", forward, input_size=(32, 32), num_classes=10)


def _fewer_layers(b, x):
    x = b.conv_bn(x, 16, 3, stride=2, name="stem")
    x = b.global_avg_pool(x)
    return b.softmax(b.dense(x, 10, name="head"))


def _bn_where_keras_has_none(b, x):
    x = b.conv_bn(x, 16, 3, stride=2, name="stem")
    x = b.add(x, b.binary_conv_bn(x, 16, 3, name="block0"))
    x = b.global_avg_pool(x)
    return b.softmax(b.binary_dense_bn(x, 10, name="head"))


def _other_kernel_shape(b, x):
    x = b.conv_bn(x, 16, 5, stride=2, name="stem")
    x = b.add(x, b.binary_conv_bn(x, 16, 3, name="block0"))
    x = b.global_avg_pool(x)
    return b.softmax(b.dense(x, 10, name="head"))


@pytest.mark.parametrize("forward,match", [
    (_fewer_layers, "layer count mismatch"),
    (_bn_where_keras_has_none, "BN mismatch at head"),
    (_other_kernel_shape, "kernel shape mismatch at stem"),
])
def test_mismatch_raises(keras_model, forward, match):
    with pytest.raises(ValueError, match=match):
        import_keras_weights(keras_model, _spec(forward))
    with pytest.raises(ValueError, match=match):
        jki.import_keras_weights(keras_model, JModelSpec(
            "wrong", forward, input_size=(32, 32), num_classes=10))


def test_missing_bias_raises():
    L = tf.keras.layers
    inp = L.Input((32, 32, 3))
    x = L.Conv2D(16, 3, strides=2, padding="same", use_bias=False)(inp)
    x = L.BatchNormalization()(x)
    x = L.GlobalAveragePooling2D()(x)
    model = tf.keras.Model(inp, L.Softmax()(L.Dense(10, use_bias=False)(x)))
    with pytest.raises(ValueError, match="expects a bias"):
        import_keras_weights(model, _spec(_fewer_layers))
