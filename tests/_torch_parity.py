"""Shared helpers of the ``test_torch_*.py`` files that hold the PyTorch port
against the JAX package: inputs made from a seed with numpy, the stated
tolerances, and the comparisons. Not a test file.

``python tests/_torch_parity.py`` rewrites
``tests/fixtures/torch_quicknet_graph_program.json`` (needs TensorFlow).
"""

import json
import os

import numpy as np
import torch

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
QUICKNET_PROGRAM = os.path.join(FIXTURES,
                                "torch_quicknet_graph_program.json")

# Float32 model outputs (probabilities or logits) of the port against JAX's:
# the float layers of the two round in different places.
FLOAT32_MODEL_TOL = dict(atol=1e-2, rtol=1e-2)

TINY = dict(section_filters=(32, 64), section_blocks=(1, 1), num_classes=10,
            input_size=32)


def images(seed, batch, size=(32, 32), dtype=np.float32):
    """A batch of NHWC images from ``seed``: standard normal floats, or the
    whole range of an integer ``dtype``."""
    rng = np.random.default_rng(seed)
    shape = (batch, *size, 3)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max + 1, shape).astype(dtype)
    return rng.normal(0, 1, shape).astype(dtype)


def to_numpy(x):
    """numpy view of a JAX array, a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_outputs_close(got, want, atol, rtol=0.0, top1=True):
    """Model outputs of the port against the reference's, within the stated
    tolerance and, with ``top1``, with the same prediction on every row."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    if top1:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def assert_trees_equal(got, want, path=""):
    """Nested dicts (parameter trees, artifact layers): the same keys, arrays
    equal element for element with equal dtypes, everything else equal.
    Tuples and lists compare as lists (JSON turns one into the other)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, torch.Tensor)) or hasattr(
            want, "__array__"):
        g, w = to_numpy(got), to_numpy(want)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)
    elif isinstance(want, (tuple, list)):
        assert list(got) == list(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def tracing_builder(builder_cls, is_int8, values_of):
    """A subclass of a PackedBuilder that records, in order, the name and
    the int8 values of every Int8Tensor a layer method returns."""
    class Tracing(builder_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stream = []

    def wrap(method):
        def traced(self, *a, **kw):
            out = getattr(builder_cls, method)(self, *a, **kw)
            if is_int8(out):
                self.stream.append((kw.get("name", method), values_of(out)))
            return out
        return traced

    for method in ("conv_bn", "depthwise_conv_bn", "binary_conv_bn",
                   "binary_dense_bn", "dense", "add", "max_pool", "flatten"):
        setattr(Tracing, method, wrap(method))
    return Tracing


def keras_twin(spec, seed=42):
    """The Keras twin of ``spec`` (a ModelSpec of either package) with random
    weights from ``seed`` and the plain convs and denses that consume a sign
    binarised, as the graph importer demands. Keras's layer-name counters are
    reset first, so the twin's layer names, and with them the names in an
    imported program, do not depend on what was built before."""
    import tensorflow as tf
    from test_keras_golden import build_keras_twin

    tf.keras.backend.clear_session()
    model, binary_layers = build_keras_twin(spec, np.random.default_rng(seed))
    for lname in binary_layers:
        layer = model.get_layer(lname)
        (w,) = layer.get_weights()
        layer.set_weights([np.where(w < 0, -1.0, 1.0).astype(np.float32)])
    return model


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return list(np.shape(tree))


def quicknet_program_fixture(import_keras_model, get_model):
    """What the fixture file holds: full QuickNet's graph program as
    ``import_keras_model`` of its Keras twin gives it, with the input size,
    the class count and the parameters' names and shapes in order."""
    spec, params = import_keras_model(keras_twin(get_model("quicknet")))
    return json.loads(json.dumps({
        "input_size": list(spec.input_size),
        "num_classes": spec.num_classes,
        "program": spec.forward.program,
        "params": [[name, _shapes(entry)] for name, entry in params.items()],
    }))


if __name__ == "__main__":
    import sys

    tests_dir = os.path.dirname(FIXTURES)
    sys.path[:0] = [tests_dir, os.path.dirname(tests_dir)]
    import conftest  # noqa: F401  (JAX on the CPU, for test_keras_golden)
    from compute_engine_tpu_torch.converter import import_keras_model
    from compute_engine_tpu_torch.models import get_model

    os.makedirs(FIXTURES, exist_ok=True)
    with open(QUICKNET_PROGRAM, "w") as f:
        json.dump(quicknet_program_fixture(import_keras_model, get_model), f,
                  indent=1)
        f.write("\n")
    print(QUICKNET_PROGRAM)
