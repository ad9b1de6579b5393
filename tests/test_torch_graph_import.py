"""The port's Keras graph importer against the JAX package's, on the Keras
twins of tests/test_graph_import.py: the same Keras model goes through both
``import_keras_model``; programs must be equal as JSON and params array for
array, and the program replayed by the port's builders must agree with JAX's
replay. The port runs on the CPU (plain versions of its kernels)."""

import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

from compute_engine_tpu.converter import graph_import as jgi  # noqa: E402
from compute_engine_tpu.models import (convert_model as jconvert,  # noqa: E402
                                       float_apply as jfloat_apply,
                                       get_model as jget_model,
                                       packed_apply as jpacked_apply,
                                       tiny_quicknet as jtiny_quicknet)
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec  # noqa: E402

from compute_engine_tpu_torch.converter import (graph_int8_ranges,  # noqa: E402
                                                import_keras_model,
                                                spec_from_program)
from compute_engine_tpu_torch.converter.graph_import import (  # noqa: E402
    GraphImportError)
from compute_engine_tpu_torch.models import (InitBuilder,  # noqa: E402
                                             calibrate_model, convert_model,
                                             float_apply, get_model,
                                             init_model, packed_apply)

import _torch_parity as parity  # noqa: E402

L = tf.keras.layers


# -- twins built from a spec's forward (tests/test_graph_import.py) ---------

def small_bireal(b, x, num_classes=10):
    x = b.conv_bn(x, 32, 7, stride=2, name="stem_conv")
    x = b.max_pool(x, 3, 2)
    for s, f in enumerate((32, 64)):
        for i in range(2):
            stride = 2 if (s > 0 and i == 0) else 1
            if stride == 2:
                shortcut = b.avg_pool(x, 2, 2, padding="SAME")
                shortcut = b.conv_bn(shortcut, f, 1, name=f"shortcut_{s}")
            else:
                shortcut = x
            y = b.binary_conv_bn(x, f, 3, stride=stride, pad_value=0,
                                 name=f"stage_{s}_block_{i}")
            x = b.add(shortcut, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def small_densenet(b, x, num_classes=10):
    x = b.conv_bn(x, 32, 7, stride=2, activation="relu", name="stem_conv")
    x = b.max_pool(x, 3, 2)
    for block_idx, n_layers in enumerate((2, 2)):
        for i in range(n_layers):
            y = b.binary_conv_bn(x, 32, 3, pad_value=1,
                                 name=f"block_{block_idx}_layer_{i}")
            x = b.concat([x, y])
        if block_idx == 0:
            x = b.conv_bn(x, 64, 1, activation="relu", name="transition_0")
            x = b.avg_pool(x, 2, 2)
    x = b.activation(x, "relu")
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def alex_tail(b, x, num_classes=10):
    x = b.conv_bn(x, 16, 3, stride=2, name="stem")
    x = b.binary_conv_bn(x, 32, 3, pad_value=1, name="c2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 64, name="fc1")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def grouped_net(b, x, num_classes=10):
    x = b.conv_bn(x, 64, 3, stride=2, name="stem")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, groups=2, name="g1")
    y = b.binary_conv_bn(x, 64, 3, pad_value=1, groups=2, name="g2")
    x = b.add(x, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def dilated_net(b, x, num_classes=10):
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    y = b.binary_conv_bn(x, 32, 3, pad_value=1, dilation=2, name="d1")
    x = b.add(x, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def rect_net(b, x, num_classes=6):
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    y = b.binary_conv_bn(x, 32, (1, 5), pad_value=1, name="rect_a")
    x = b.add(x, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def _spec_twin(name, forward, size, num_classes):
    return lambda: parity.keras_twin(JModelSpec(
        name, forward, input_size=(size, size), num_classes=num_classes))


# -- twins written in Keras directly ----------------------------------------

def _sign():
    return L.Lambda(lambda t: tf.where(t < 0, -tf.ones_like(t),
                                       tf.ones_like(t)))


def _randomise(model, rng, scale=0.5, only_variance=False):
    for v in model.weights:
        shape = v.shape.as_list()
        if "moving_variance" in v.name:
            v.assign(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        elif not only_variance:
            v.assign(rng.normal(0, scale, shape).astype(np.float32))


def _binarise(model, name, scale=1.0):
    (w,) = model.get_layer(name).get_weights()
    model.get_layer(name).set_weights(
        [np.where(w < 0, -1.0, 1.0).astype(np.float32) * scale])


def quant_classes():
    """larq's Quant* layers are recognised by class name."""
    rng = np.random.default_rng(42)
    QuantConv2D = type("QuantConv2D", (L.Conv2D,), {})
    QuantDense = type("QuantDense", (L.Dense,), {})
    inp = L.Input((16, 16, 8))
    x = L.Conv2D(16, 3, strides=2, padding="same", use_bias=False)(inp)
    x = L.BatchNormalization()(x)
    y = QuantConv2D(16, 3, padding="same", use_bias=False)(x)
    y = L.BatchNormalization()(y)
    x = L.Add()([x, y])
    x = L.GlobalAveragePooling2D()(x)
    x = QuantDense(32, use_bias=False)(x)
    x = L.BatchNormalization()(x)
    x = L.Dense(10)(x)
    model = tf.keras.Model(inp, L.Softmax()(x))
    _randomise(model, rng)
    return model


def _strided_pad_model(hw):
    inp = L.Input((hw, hw, 4))
    y = _sign()(inp)
    y = L.ZeroPadding2D(((0, 1), (0, 1)))(y)
    y = L.Conv2D(8, 3, strides=2, padding="valid", use_bias=False,
                 name="bconv")(y)
    y = L.BatchNormalization()(y)
    y = L.GlobalAveragePooling2D()(y)
    y = L.Dense(4)(y)
    model = tf.keras.Model(inp, L.Softmax()(y))
    _binarise(model, "bconv")
    _randomise(model, np.random.default_rng(42), only_variance=True)
    return model


def strided_pad_fold():
    """A (0,1)x(0,1) zero pad + VALID 3x3/2 conv on 16x16 is the SAME conv."""
    return _strided_pad_model(16)


def binary_scale():
    """A +-scale kernel per output channel: the scale folds into the BN."""
    rng = np.random.default_rng(42)
    inp = L.Input((16, 16, 4))
    y = _sign()(inp)
    y = L.Conv2D(8, 3, padding="same", use_bias=False, name="bconv")(y)
    y = L.BatchNormalization()(y)
    y = L.GlobalAveragePooling2D()(y)
    y = L.Dense(4)(y)
    model = tf.keras.Model(inp, L.Softmax()(y))
    _randomise(model, rng)
    _binarise(model, "bconv", rng.uniform(0.5, 2.0, 8).astype(np.float32))
    return model


def _fq(mn, mx):
    return L.Lambda(lambda t: tf.quantization.fake_quant_with_min_max_args(
        t, min=mn, max=mx))


def fakequant():
    """A QAT graph: the ranges of its fake-quant ops are absorbed."""
    inp = L.Input((16, 16, 3))
    y = _fq(-3.0, 3.0)(inp)
    y = L.Conv2D(8, 3, strides=2, padding="same", use_bias=False,
                 name="c1")(y)
    y = L.BatchNormalization()(y)
    y = _fq(-6.0, 6.0)(y)
    y = L.Conv2D(8, 3, padding="same", use_bias=False, name="c2")(y)
    y = L.BatchNormalization()(y)
    y = L.GlobalAveragePooling2D()(y)
    y = L.Dense(4, name="head")(y)
    model = tf.keras.Model(inp, L.Softmax()(y))
    _randomise(model, np.random.default_rng(42), scale=0.3)
    return model


def fakequant_pool():
    """fq -> pool -> conv: the range reaches the conv through the pool."""
    inp = L.Input((16, 16, 3))
    y = L.Conv2D(8, 3, padding="same", use_bias=False, name="c1")(inp)
    y = L.BatchNormalization()(y)
    y = _fq(-4.0, 4.0)(y)
    y = L.MaxPooling2D(2, 2)(y)
    y = L.Conv2D(8, 3, padding="same", use_bias=False, name="c2")(y)
    y = L.BatchNormalization()(y)
    y = L.GlobalAveragePooling2D()(y)
    y = L.Dense(4)(y)
    model = tf.keras.Model(inp, L.Softmax()(y))
    _randomise(model, np.random.default_rng(42), only_variance=True)
    return model


TWINS = {
    "tiny_quicknet": lambda: parity.keras_twin(jtiny_quicknet(**parity.TINY)),
    "birealnet": _spec_twin("small_bireal", small_bireal, 64, 10),
    "densenet": _spec_twin("small_densenet", small_densenet, 64, 10),
    "binary_dense_flatten": _spec_twin("alex_tail", alex_tail, 32, 10),
    "grouped": _spec_twin("grouped_net", grouped_net, 32, 10),
    "dilated": _spec_twin("dilated_net", dilated_net, 32, 10),
    "rectangular": _spec_twin("rect_net", rect_net, 32, 6),
    "strided_pad_fold": strided_pad_fold,
    "quant_classes": quant_classes,
    "binary_scale": binary_scale,
    "fakequant": fakequant,
    "fakequant_pool": fakequant_pool,
}


@pytest.fixture(scope="module")
def imported():
    """Each Keras twin, built once, through both importers:
    name -> ((jspec, jparams), (spec, params))."""
    out = {}
    for name, build in TWINS.items():
        model = build()
        out[name] = (jgi.import_keras_model(model), import_keras_model(model))
    return out


@pytest.mark.parametrize("name", TWINS)
def test_program_and_params_equal_jax(imported, name):
    (jspec, jparams), (spec, params) = imported[name]
    assert json.dumps(spec.forward.program) == json.dumps(
        jspec.forward.program)
    assert (spec.name, spec.input_size, spec.num_classes) == (
        jspec.name, jspec.input_size, jspec.num_classes)
    parity.assert_trees_equal(params, jparams)
    ops = [rec["op"] for rec in spec.forward.program["ops"]]
    if name == "quant_classes":
        assert "binary_conv_bn" in ops and "binary_dense_bn" in ops
    if name == "binary_scale":
        assert np.allclose(np.abs(params["bconv"]["kernel"]), 1.0, atol=1e-5)
    if name == "strided_pad_fold":
        kw = spec.forward.program["ops"][ops.index("binary_conv_bn")]["kw"]
        assert kw["padding"] == "SAME" and kw["pad_value"] == 0


@pytest.mark.parametrize("name", TWINS)
def test_graph_int8_ranges_equal_jax(imported, name):
    (jspec, _), (spec, _) = imported[name]
    got, want = graph_int8_ranges(spec), jgi.graph_int8_ranges(jspec)
    assert got == want
    assert bool(got[0]) == name.startswith("fakequant")
    if name == "fakequant_pool":
        assert abs(got[0]["c2"] - 4.0) < 0.1 and abs(got[1]["c1"] - 4.0) < 0.1


@pytest.mark.parametrize("name", TWINS)
def test_replay_after_json_round_trip(imported, name):
    """``spec_from_program`` of the program after a JSON round trip (the form
    an artifact's header holds) replays through ``FloatBuilder``,
    ``ConvertBuilder`` and ``PackedBuilder`` to the outputs of the
    un-serialised spec bit for bit, and to JAX's replay within the float32
    model tolerance."""
    (jspec, jparams), (spec, params) = imported[name]
    prog = json.loads(json.dumps(spec.forward.program))
    spec2 = spec_from_program(prog, input_size=spec.input_size,
                              num_classes=spec.num_classes)
    assert graph_int8_ranges(spec2) == graph_int8_ranges(spec)
    channels = 3 if name not in ("quant_classes", "strided_pad_fold",
                                 "binary_scale") else (
        8 if name == "quant_classes" else 4)
    x = np.random.default_rng(7).normal(
        0, 1, (2, *spec.input_size, channels)).astype(np.float32)
    with torch.no_grad():
        want = float_apply(spec, params, x, device="cpu")
        got = float_apply(spec2, params, x, device="cpu")
    assert torch.equal(got, want)
    parity.assert_outputs_close(
        got, jfloat_apply(jspec, jparams, jnp.asarray(x)),
        **parity.FLOAT32_MODEL_TOL)
    if channels != 3:
        return  # the entry points trace a 3-channel input
    layers = convert_model(spec2, params)
    parity.assert_trees_equal(layers, convert_model(spec, params))
    parity.assert_trees_equal(layers, jconvert(jspec, jparams))
    got_p = packed_apply(spec2, layers, x, compute_dtype=torch.float32,
                         device="cpu")
    assert torch.equal(got_p, packed_apply(
        spec, layers, x, compute_dtype=torch.float32, device="cpu"))
    parity.assert_outputs_close(
        got_p, jpacked_apply(jspec, layers, jnp.asarray(x),
                             compute_dtype=jnp.float32),
        **parity.FLOAT32_MODEL_TOL)


def test_replay_drives_every_builder(imported):
    """The records' keyword names (lists for sizes, as JSON gives them) are
    taken by every builder of the port: Init on the meta device, Calibrate,
    Convert with int8 ranges, Packed in both domains and with int8 layers."""
    _, (spec, params) = imported["binary_dense_flatten"]
    spec = spec_from_program(json.loads(json.dumps(spec.forward.program)),
                             input_size=spec.input_size,
                             num_classes=spec.num_classes)
    fresh = init_model(spec, seed=1, randomize_bn=True)
    assert list(fresh) == list(params)
    for lname, entry in params.items():
        assert tuple(fresh[lname]["kernel"].shape) == entry["kernel"].shape
    b = InitBuilder(seed=1)
    spec.forward(b, torch.empty((1, 32, 32, 3), device="meta"))
    assert list(b.params) == list(params)
    x = parity.images(3, 2)
    in_r, out_r = calibrate_model(spec, params, [x], with_outputs=True,
                                  device="cpu")
    layers8 = convert_model(spec, params, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    assert any("kernel_int8" in a for a in layers8.values())
    layers = convert_model(spec, params)
    outs = [packed_apply(spec, layers, x, compute_dtype=torch.float32,
                         device="cpu", domain=domain)
            for domain in ("float", "packed")]
    outs.append(packed_apply(spec, layers8, x, device="cpu"))
    for out in outs:
        assert tuple(out.shape) == (2, 10)
        assert bool(torch.isfinite(out).all())
    assert (outs[0].argmax(-1) == outs[1].argmax(-1)).all()


def test_qat_ranges_convert_to_jax_int8_artifact(imported):
    """The absorbed ranges drive the int8 conversion with no calibration, to
    the arrays JAX converts to; the int8 forward stays near the float one."""
    (jspec, jparams), (spec, params) = imported["fakequant"]
    in_r, out_r = graph_int8_ranges(spec)
    layers8 = convert_model(spec, params, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    assert "kernel_int8" in layers8["c1"] and "out_scale" in layers8["c1"]
    parity.assert_trees_equal(layers8, jconvert(
        jspec, jparams, int8_ranges=in_r, int8_out_ranges=out_r))
    x = np.random.default_rng(7).normal(0, 1, (4, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = float_apply(spec, params, x, device="cpu")
    got = packed_apply(spec, layers8, x, compute_dtype=torch.float32,
                       device="cpu")
    parity.assert_outputs_close(got, want, atol=0.05, top1=False)


def _functional(body):
    inp = L.Input((16, 16, 4))
    return tf.keras.Model(inp, body(inp))


def _conv_without_bn(x):
    return L.Conv2D(4, 3, use_bias=False, name="lonely")(x)


def _conv_bias(x):
    return L.BatchNormalization()(L.Conv2D(4, 3, use_bias=True,
                                           name="biased")(x))


def _unknown_layer(x):
    return L.Lambda(lambda t: t * 2.0 + 1.0, name="affine")(x)


def _unfoldable_pad(x):
    y = _sign()(x)
    y = L.Lambda(lambda t: tf.pad(t, [[0, 0], [3, 3], [3, 3], [0, 0]],
                                  constant_values=1.0))(y)
    y = L.Conv2D(4, 3, padding="valid", use_bias=False, name="overpadded")(y)
    return L.BatchNormalization()(y)


def _sign_into_non_binary_op(x):
    return L.GlobalAveragePooling2D(name="pooled")(_sign()(x))


def _float_kernel_on_binary_input(x):
    y = L.Conv2D(4, 3, padding="same", use_bias=False,
                 name="real_valued")(_sign()(x))
    return L.BatchNormalization()(y)


@pytest.mark.parametrize("body,layer,match", [
    (_conv_without_bn, "lonely", "without a following"),
    (_conv_bias, "biased", "bias"),
    (_unknown_layer, "affine", "unsupported layer"),
    (_unfoldable_pad, "overpadded", "does not match the SAME"),
    (_sign_into_non_binary_op, "pooled", "binary conv/dense"),
    (_float_kernel_on_binary_input, "real_valued", "not binary"),
])
def test_rejects(body, layer, match):
    """The six rejections of tests/test_graph_import.py raise the port's
    ``GraphImportError`` (a ``ValueError``, and not JAX's class) with the
    layer named."""
    with pytest.raises(GraphImportError, match=match) as err:
        import_keras_model(_functional(body))
    assert layer in str(err.value)
    assert not isinstance(err.value, jgi.GraphImportError)
    assert isinstance(err.value, ValueError)


def test_rejects_pad_that_is_not_same_on_odd_input():
    """On 17x17 the (0,1)x(0,1) pad is not the SAME amount (1,1)."""
    with pytest.raises(GraphImportError, match="does not match the SAME"):
        import_keras_model(_strided_pad_model(17))


def test_replay_refuses_unknown_op():
    spec = spec_from_program({"ops": [{"op": "eval", "in": [0], "out": 1}],
                              "out": 1}, input_size=(8, 8), num_classes=2)
    with pytest.raises(GraphImportError, match="unknown program op"):
        init_model(spec)


def test_full_quicknet_program_fixture():
    """The committed program of full-width QuickNet (what a run on a machine
    without TensorFlow builds its self-contained artifact from) is what the
    port's importer gives for QuickNet's Keras twin, and what JAX's gives
    for the same Keras model; its parameters line up, in order and shape,
    with the zoo's."""
    with open(parity.QUICKNET_PROGRAM) as f:
        committed = json.load(f)
    assert parity.quicknet_program_fixture(
        import_keras_model, get_model) == committed
    assert parity.quicknet_program_fixture(
        jgi.import_keras_model, jget_model) == committed
    zoo = init_model(get_model("quicknet"), seed=0)
    assert len(zoo) == len(committed["params"])
    for (_, shapes), entry in zip(committed["params"], zoo.values()):
        assert shapes["kernel"] == list(entry["kernel"].shape)
        assert shapes.keys() == entry.keys()
    ops = [rec["op"] for rec in committed["program"]["ops"]]
    assert ops.count("binary_conv_bn") == 16 and ops.count("add") == 16
