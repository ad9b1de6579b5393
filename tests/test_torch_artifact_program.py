"""The self-contained artifact (packed weights and the graph program in one
file) across the two packages: one written by the JAX package loads in the
port's ``Interpreter`` with no model named, and one written by the port loads
in JAX's. The port runs on the CPU."""

import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

from compute_engine_tpu.converter import (graph_int8_ranges as jranges,  # noqa: E402
                                          import_keras_model as jimport,
                                          load_artifact as jload,
                                          save_artifact as jsave,
                                          spec_from_program as jspec_from)
from compute_engine_tpu.models import (Int8Tensor as JInt8Tensor,  # noqa: E402
                                       PackedBuilder as JPackedBuilder,
                                       convert_model as jconvert,
                                       tiny_quicknet as jtiny_quicknet)
from compute_engine_tpu.runtime import Interpreter as JInterpreter  # noqa: E402

from compute_engine_tpu_torch.converter import (graph_int8_ranges,  # noqa: E402
                                                import_keras_model,
                                                load_artifact, save_artifact,
                                                spec_from_program)
from compute_engine_tpu_torch.interop import layers_from_numpy  # noqa: E402
from compute_engine_tpu_torch.models import (Int8Tensor,  # noqa: E402
                                             PackedBuilder, convert_model)
from compute_engine_tpu_torch.runtime import Interpreter  # noqa: E402

import _torch_parity as parity  # noqa: E402

L = tf.keras.layers

JTracing = parity.tracing_builder(
    JPackedBuilder, lambda o: isinstance(o, JInt8Tensor),
    lambda o: np.asarray(o.values))
Tracing = parity.tracing_builder(
    PackedBuilder, lambda o: isinstance(o, Int8Tensor),
    lambda o: o.values.numpy())


def _header(spec, **more):
    return {"graph_program": spec.forward.program,
            "input_size": list(spec.input_size),
            "num_classes": spec.num_classes, **more}


@pytest.fixture(scope="module")
def tiny_artifacts(tmp_path_factory):
    """Tiny QuickNet's Keras twin imported and converted by each package,
    each saved by its own ``save_artifact`` with the graph program."""
    model = parity.keras_twin(jtiny_quicknet(**parity.TINY))
    tmp = tmp_path_factory.mktemp("artifacts")
    jspec, jparams = jimport(model)
    jpath = str(tmp / "from_jax.npz")
    jsave(jpath, jconvert(jspec, jparams), jspec.name, _header(jspec))
    spec, params = import_keras_model(model)
    path = str(tmp / "from_port.npz")
    save_artifact(path, convert_model(spec, params), spec.name, _header(spec))
    return jpath, path


def test_the_two_packages_write_the_same_artifact(tiny_artifacts):
    (jname, jconfig, jlayers), (name, config, layers) = (
        jload(tiny_artifacts[0]), load_artifact(tiny_artifacts[1]))
    assert name == jname and config == jconfig
    assert config["graph_program"]["ops"]
    parity.assert_trees_equal(layers, jlayers)


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_self_contained_artifact_loads_in_both(tiny_artifacts, written_by):
    """No model is named: the spec comes from the header's program."""
    path = tiny_artifacts[written_by == "port"]
    x = parity.images(5, 4)
    want = JInterpreter(artifact_path=path,
                        compute_dtype=jnp.float32).predict(x)
    interp = Interpreter(artifact_path=path, compute_dtype=torch.float32,
                         device="cpu")
    assert interp.spec.input_size == (32, 32)
    assert interp.spec.num_classes == 10
    assert interp.spec.forward.program["ops"]
    got = interp.predict(x)
    assert got.shape == (4, 10)
    parity.assert_outputs_close(got, want, **parity.FLOAT32_MODEL_TOL)


def test_named_model_still_wins_over_the_program(tiny_artifacts):
    """``model=`` given: the header's program is not consulted."""
    from compute_engine_tpu_torch.models import tiny_quicknet

    with pytest.raises(KeyError):  # the twin's layer names are Keras's
        Interpreter(tiny_quicknet(**parity.TINY),
                    artifact_path=tiny_artifacts[1], device="cpu")(
            parity.images(5, 1))


def qat_graph():
    """A QAT graph whose fake-quant ops give every layer up to the head its
    ranges: int8 conv -> int8 max pool -> int8 conv -> binary conv with int8
    output -> int8 dense head."""
    def fq(r):
        return L.Lambda(
            lambda t: tf.quantization.fake_quant_with_min_max_args(
                t, min=-r, max=r))

    rng = np.random.default_rng(11)
    inp = L.Input((16, 16, 3))
    y = fq(3.0)(inp)
    y = L.Conv2D(32, 3, padding="same", use_bias=False, name="c1")(y)
    y = L.BatchNormalization()(y)
    y = fq(6.0)(y)
    y = L.MaxPooling2D(2, 2)(y)
    y = L.Conv2D(32, 3, padding="same", use_bias=False, name="c2")(y)
    y = L.BatchNormalization()(y)
    y = fq(5.0)(y)
    y = L.Lambda(lambda t: tf.where(t < 0, -tf.ones_like(t),
                                    tf.ones_like(t)))(y)
    y = L.Conv2D(32, 3, padding="same", use_bias=False, name="bin")(y)
    y = L.BatchNormalization()(y)
    y = fq(40.0)(y)
    y = L.GlobalAveragePooling2D()(y)
    y = L.Dense(4, name="head")(y)
    model = tf.keras.Model(inp, L.Softmax()(y))
    for v in model.weights:
        shape = v.shape.as_list()
        if "moving_variance" in v.name:
            v.assign(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        else:
            v.assign(rng.normal(0, 0.3, shape).astype(np.float32))
    (w,) = model.get_layer("bin").get_weights()
    model.get_layer("bin").set_weights(
        [np.where(w < 0, -1.0, 1.0).astype(np.float32)])
    return model


def test_qat_int8_artifact_stream_equals_jax_bit_for_bit(tmp_path):
    """The int8 artifact of a QAT graph (ranges absorbed from the graph, no
    calibration), written by the port with its program: the arrays are JAX's,
    and replayed from the file alone every int8 tensor of the stream equals
    JAX's bit for bit."""
    model = qat_graph()
    jspec, jparams = jimport(model)
    spec, params = import_keras_model(model)
    in_r, out_r = graph_int8_ranges(spec)
    assert (in_r, out_r) == jranges(jspec)
    assert set(in_r) == {"c1", "c2", "head"}
    assert set(out_r) == {"c1", "c2", "bin"}
    layers = convert_model(spec, params, int8_ranges=in_r,
                           int8_out_ranges=out_r)
    parity.assert_trees_equal(layers, jconvert(
        jspec, jparams, int8_ranges=in_r, int8_out_ranges=out_r))
    path = str(tmp_path / "qat.npz")
    save_artifact(path, layers, spec.name, _header(spec, int8=True))

    name, config, loaded = load_artifact(path)
    prog = json.loads(json.dumps(config["graph_program"]))
    x = np.random.default_rng(7).normal(0, 1.5, (4, 16, 16, 3)).astype(
        np.float32)
    jb = JTracing(jload(path)[2], compute_dtype=jnp.float32, kernel="mxu")
    want = np.asarray(jspec_from(prog, input_size=(16, 16), num_classes=4)
                      .forward(jb, jnp.asarray(x)))
    pb = Tracing(layers_from_numpy(loaded), compute_dtype=torch.float32)
    with torch.inference_mode():
        got = spec_from_program(prog, input_size=(16, 16), num_classes=4
                                ).forward(pb, torch.from_numpy(x)).numpy()
    assert [n for n, _ in pb.stream] == [n for n, _ in jb.stream] == [
        "c1", "max_pool", "c2", "bin"]
    for (lname, g), (_, w) in zip(pb.stream, jb.stream):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w, err_msg=lname)
    # The head quantises the float mean of int8 values: last bits may differ.
    parity.assert_outputs_close(got, want, atol=2e-2, top1=False)
    interp = Interpreter(artifact_path=path, compute_dtype=torch.float32,
                         device="cpu")
    np.testing.assert_array_equal(interp.predict(x), got)
