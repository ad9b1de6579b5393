"""The true-int8 pipeline (calibrate -> int8 convert -> int8 stream) through
both packages on the same numpy inputs. The port runs on the CPU with its
plain versions; the JAX side runs as its own tests run it (XLA on the CPU,
the Pallas bgemm in interpret mode)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from compute_engine_tpu.converter import save_artifact as jsave_artifact
from compute_engine_tpu.models import (
    Int8Tensor as JInt8Tensor,
    PackedBuilder as JPackedBuilder,
    calibrate_model as jcalibrate,
    convert_model as jconvert,
    float_apply as jfloat_apply,
    init_model as jinit,
    packed_apply as japply,
)
from compute_engine_tpu.models import layers as JL
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec
from compute_engine_tpu.runtime import Interpreter as JInterpreter

from compute_engine_tpu_torch.converter import (load_artifact, merge_arrays,
                                                save_artifact, split_arrays)
from compute_engine_tpu_torch.interop import layers_from_numpy
from compute_engine_tpu_torch.kernels.bgemm import bgemm_plain
from compute_engine_tpu_torch.kernels.residual import (
    binary_residual_block_plain)
from compute_engine_tpu_torch.models import (
    Int8Tensor,
    PackedBuilder,
    calibrate_model,
    convert_model,
    float_apply,
    init_model,
    packed_apply,
    tiny_quicknet,
)
from compute_engine_tpu_torch.models import layers as L
from compute_engine_tpu_torch.models.zoo import ModelSpec, _quicknet_forward
from compute_engine_tpu_torch.runtime import Interpreter
from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

from _torch_parity import tracing_builder

SEED = 9


def tiny(b, x):
    return _quicknet_forward(b, x, section_filters=(32, 64),
                             section_blocks=(1, 1), num_classes=10)


def binary_dense_model(b, x):
    """conv -> max pool -> binary conv -> flatten -> binary dense -> head:
    the int8 max pool, the int8 flatten and a binary dense on int8 values."""
    x = b.conv_bn(x, 32, 3, stride=2, activation="relu6", name="stem")
    x = b.max_pool(x, 3, 2)
    x = b.binary_conv_bn(x, 32, 3, pad_value=1, name="bconv")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 40, name="bfc")
    x = b.dense(x, 10, name="head")
    return b.softmax(x)


MODELS = {"quicknet": (tiny, 32), "binary_dense": (binary_dense_model, 16)}


def _specs(name):
    forward, size = MODELS[name]
    return (JModelSpec(name, forward, input_size=(size, size),
                       num_classes=10),
            ModelSpec(name, forward, input_size=(size, size), num_classes=10))


def _calib(size, n=3, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32)
            for _ in range(n)]


class Model:
    """One model in both packages: weights from the same seed, JAX's
    calibrated ranges, and both packages' artifacts converted from them."""

    def __init__(self, name):
        self.jspec, self.spec = _specs(name)
        self.size = MODELS[name][1]
        self.jparams = jinit(self.jspec, seed=SEED, randomize_bn=True)
        self.params = init_model(self.spec, seed=SEED, randomize_bn=True)
        self.calib = _calib(self.size)
        self.in_r, self.out_r = jcalibrate(self.jspec, self.jparams,
                                           self.calib, with_outputs=True)
        self.jlayers = jconvert(self.jspec, self.jparams,
                                int8_ranges=self.in_r,
                                int8_out_ranges=self.out_r)
        self.layers = convert_model(self.spec, self.params,
                                    int8_ranges=self.in_r,
                                    int8_out_ranges=self.out_r)

    def x(self, batch=4, seed=5):
        return np.random.default_rng(seed).normal(
            0, 1, (batch, self.size, self.size, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return Model(request.param)


@pytest.fixture(scope="module")
def quicknet():
    return Model("quicknet")


def _assert_layers_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k, v in want[name].items():
            g = got[name][k]
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype, (name, k)
                np.testing.assert_array_equal(g, v, err_msg=f"{name}/{k}")
            else:
                assert type(g) is type(v) and g == v, (name, k)


# -- the float oracle and ste_sign -------------------------------------------


def test_float_apply_matches_jax(model):
    """float32 on both sides; the convolutions sum in another order."""
    x = model.x()
    want = np.asarray(jfloat_apply(model.jspec, model.jparams,
                                   jnp.asarray(x)))
    got = float_apply(model.spec, model.params, x, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_ste_sign_gradient_matches_jax():
    x = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.25, 1.0, 1.0001, 3.0],
                 np.float32)
    w = np.arange(1, 10, dtype=np.float32)
    want_y = np.asarray(JL.ste_sign(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda t: jnp.sum(JL.ste_sign(t) * jnp.asarray(w)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = L.ste_sign(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


def test_float_apply_is_differentiable(quicknet):
    """The gradient reaches a latent binary kernel through ste_sign."""
    params = {k: dict(v) for k, v in quicknet.params.items()}
    kernel = params["section_0_block_0"]["kernel"].clone().requires_grad_()
    params["section_0_block_0"]["kernel"] = kernel
    out = float_apply(quicknet.spec, params, quicknet.x(2), device="cpu")
    out[:, 0].sum().backward()
    assert kernel.grad is not None and bool((kernel.grad != 0).any())


# -- calibration and conversion ----------------------------------------------


@pytest.mark.parametrize("table", ["in", "out"])
def test_calibrate_model_matches_jax(model, table):
    """Ranges are maxima of float-layer outputs, which differ from JAX's in
    the last bits (another summation order): same keys, rtol 1e-5."""
    got = calibrate_model(model.spec, model.params, model.calib,
                          with_outputs=True, device="cpu")
    want = {"in": model.in_r, "out": model.out_r}[table]
    got = got[0] if table == "in" else got[1]
    assert list(got) == list(want)
    assert all(isinstance(v, float) for v in got.values())
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-5)


def test_calibrate_model_without_outputs_returns_the_input_ranges(quicknet):
    got = calibrate_model(quicknet.spec, quicknet.params, quicknet.calib,
                          device="cpu")
    assert set(got) == {"stem_conv", "stem_depthwise", "stem_pointwise",
                        "transition_1", "head"}


def test_add_names_restart_with_every_batch(quicknet):
    _, out_r = calibrate_model(quicknet.spec, quicknet.params,
                               quicknet.calib, with_outputs=True,
                               device="cpu")
    assert [k for k in out_r if k.startswith("__add_")] == ["__add_0",
                                                            "__add_1"]


@pytest.mark.parametrize("ranges", ["in", "in+out", "some"])
def test_convert_model_int8_matches_jax(model, ranges):
    """From JAX's ranges the port's artifact is JAX's: every array
    byte-identical with the same dtype, every scalar equal."""
    in_r, out_r = dict(model.in_r), dict(model.out_r)
    if ranges == "in":
        out_r = None
    elif ranges == "some":  # every other layer, every other output
        in_r = dict(list(in_r.items())[::2])
        out_r = dict(list(out_r.items())[1::2])
    want = jconvert(model.jspec, model.jparams, int8_ranges=in_r,
                    int8_out_ranges=out_r)
    got = convert_model(model.spec, model.params, int8_ranges=in_r,
                        int8_out_ranges=out_r)
    _assert_layers_equal(got, want)
    assert any("kernel_int8" in e for e in got.values())


def test_int8_artifact_entries(quicknet):
    layers = quicknet.layers
    for name in ("stem_conv", "stem_depthwise", "stem_pointwise",
                 "transition_1", "head"):
        e = layers[name]
        assert e["kernel_int8"].dtype == np.int8 and "kernel" not in e
        assert e["w_scale"].dtype == np.float32
        assert isinstance(e["in_scale"], float)
        assert isinstance(e["out_scale"], float)
    assert layers["stem_depthwise"]["w_scale"].shape == (8,)
    assert layers["__add_0"] == {
        "kind": "add", "out_scale": quicknet.out_r["__add_0"] / 127.0}
    assert layers["section_0_block_0"]["int8_multiplier"].dtype == np.float32


# -- artifacts ----------------------------------------------------------------


def _port_forward(spec, layers, x, **kw):
    return packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu", **kw).numpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_artifact_loads_in_port(tmp_path, quicknet, writer):
    """An int8 .npz written by either package loads into the port: int8
    kernels stay int8, scales stay Python floats, an "add" entry (no array)
    survives, and the forward is the one of the layers in memory."""
    path = str(tmp_path / "q.npz")
    if writer == "jax":
        jsave_artifact(path, quicknet.jlayers, "quicknet")
    else:
        save_artifact(path, quicknet.layers, "quicknet")
    _, _, loaded = load_artifact(path)
    assert loaded.keys() == quicknet.layers.keys()
    for name, entry in quicknet.layers.items():
        assert loaded[name].keys() == entry.keys(), name
        for k, v in entry.items():
            g = loaded[name][k]
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype, (name, k)
                np.testing.assert_array_equal(g, v)
            elif isinstance(v, tuple):
                assert tuple(g) == v
            else:
                assert type(g) is type(v) and g == v, (name, k)
    x = quicknet.x()
    np.testing.assert_array_equal(
        _port_forward(quicknet.spec, loaded, x),
        _port_forward(quicknet.spec, quicknet.layers, x))


def test_int8_layers_move_to_the_device_and_split(quicknet):
    runtime = layers_from_numpy(quicknet.layers)
    e = runtime["stem_conv"]
    assert e["kernel_int8"].dtype == torch.int8
    assert e["w_scale"].dtype == torch.float32
    assert isinstance(e["in_scale"], float)
    assert runtime["__add_1"] == quicknet.layers["__add_1"]
    static, arrays = split_arrays(quicknet.layers)
    assert "__add_0" in static and "__add_0" not in arrays
    assert "in_scale" in static["head"] and "kernel_int8" in arrays["head"]
    _assert_layers_equal(merge_arrays(static, arrays), quicknet.layers)


# -- the exact integer layers --------------------------------------------------


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


@pytest.mark.parametrize("ksize,stride,dilation,groups,c_in,c_out", [
    (3, 2, 1, 1, 3, 8),      # the stem conv (K = 27)
    (1, 1, 1, 1, 16, 64),    # a pointwise conv
    (3, 1, 2, 1, 5, 7),      # dilated, odd widths
    (3, 2, 1, 2, 8, 6),      # grouped
    ((1, 3), (2, 1), 1, 1, 4, 4),
])
def test_conv2d_int8_is_exact(rng, ksize, stride, dilation, groups, c_in,
                              c_out):
    """Equal to JAX's int32 conv and to torch's own integer conv on the CPU."""
    pair = lambda v: (v, v) if isinstance(v, int) else v  # noqa: E731
    (kh, kw), stride, dilation = pair(ksize), pair(stride), pair(dilation)
    x = _int8(rng, (2, 9, 11, c_in))
    k = _int8(rng, (kh, kw, c_in // groups, c_out))
    got = L.conv2d_int8(torch.from_numpy(x), torch.from_numpy(k), stride,
                        "SAME", groups=groups, dilation=dilation)
    assert got.dtype == torch.int32
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), window_strides=stride,
        padding="SAME", rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # torch's own CPU conv: in int32, or in float64 (as exact) where it is
    # dilated, which the integer conv does not take.
    wide = torch.int32 if dilation == (1, 1) else torch.float64
    xn = torch.from_numpy(x).permute(0, 3, 1, 2).to(wide)
    kn = torch.from_numpy(k).permute(3, 2, 0, 1).to(wide)
    for padding, inp in (("SAME", L._same_pad(xn, (kh, kw), stride, dilation,
                                              value=0)), ("VALID", xn)):
        own = F.conv2d(inp, kn, stride=stride, dilation=dilation,
                       groups=groups).permute(0, 2, 3, 1).to(torch.int32)
        ours = L.conv2d_int8(torch.from_numpy(x), torch.from_numpy(k), stride,
                             padding, groups=groups, dilation=dilation)
        assert torch.equal(ours, own), padding


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_int8_is_exact(rng, stride):
    x = _int8(rng, (2, 9, 12, 6))
    k = _int8(rng, (3, 3, 6, 1))
    got = L.depthwise_conv2d_int8(torch.from_numpy(x), torch.from_numpy(k),
                                  (stride, stride))
    assert got.dtype == torch.int32
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k).reshape(3, 3, 1, 6),
        window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=6,
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_integer_sums_never_round():
    """K = 2048 products of 127 * 127 sum to 33,032,192, above 2**24, where
    a float32 sum would round: the integer layers return it exactly. A depth
    whose sum could pass int32 is refused, not wrapped."""
    a = torch.full((3, 2048), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((2048, 5), 127, dtype=torch.int8)
    b[7, :] = 126
    want = 2048 * 127 * 127 - 127
    got = L.dense_int8(a, b)
    assert got.dtype == torch.int32
    assert got[0].tolist() == [want] * 5 and got[1].tolist() == [-want] * 5
    assert float(np.float32(want)) != want  # float32 cannot hold it
    conv = L.conv2d_int8(a.reshape(3, 1, 1, 2048), b.reshape(1, 1, 2048, 5))
    assert torch.equal(conv.reshape(3, 5), got)
    deep = torch.zeros((1, 133_200), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        L.int_matmul(deep, deep.t())


@pytest.mark.parametrize("fn,args", [
    (L.int_matmul, (torch.zeros(2, 3), torch.zeros((3, 2), dtype=torch.int8))),
    (L.conv2d_int8, (torch.zeros((1, 4, 4, 3), dtype=torch.int8),
                     torch.zeros((3, 3, 3, 2), dtype=torch.int32))),
    (L.depthwise_conv2d_int8, (torch.zeros((1, 4, 4, 3)),
                               torch.zeros((3, 3, 3, 1), dtype=torch.int8))),
])
def test_integer_layers_refuse_other_types(fn, args):
    with pytest.raises(TypeError, match="must be int8"):
        fn(*args)


# -- stepwise through PackedBuilder --------------------------------------------


JTracing = tracing_builder(JPackedBuilder,
                           lambda o: isinstance(o, JInt8Tensor),
                           lambda o: np.asarray(o.values))
Tracing = tracing_builder(PackedBuilder, lambda o: isinstance(o, Int8Tensor),
                          lambda o: o.values.numpy())


def _t8(values, scale):
    return Int8Tensor(torch.from_numpy(np.array(values)), scale)


@pytest.fixture(scope="module")
def jax_steps(quicknet):
    """QuickNet's int8 layers run one by one through JAX's PackedBuilder:
    each layer's input (numpy int8 and its scale, or the float image) and
    its int8 output."""
    pb = JPackedBuilder(quicknet.jlayers, compute_dtype=jnp.float32,
                        kernel="mxu")
    x = quicknet.x(3)
    steps = {}

    def record(name, inp, out):
        assert isinstance(out, JInt8Tensor) and out.values.dtype == jnp.int8
        if isinstance(inp, JInt8Tensor):
            inp = (np.asarray(inp.values), inp.scale)
        steps[name] = (inp, np.asarray(out.values), out.scale)
        return out

    y1 = record("stem_conv", x, pb.conv_bn(
        jnp.asarray(x), 8, 3, stride=2, activation="relu", name="stem_conv"))
    y2 = record("stem_depthwise", y1, pb.depthwise_conv_bn(
        y1, 3, stride=2, activation="relu", name="stem_depthwise"))
    y3 = record("stem_pointwise", y2, pb.conv_bn(y2, 32, 1,
                                                 name="stem_pointwise"))
    b0 = record("section_0_block_0", y3, pb.binary_conv_bn(
        y3, 32, 3, pad_value=1, name="section_0_block_0"))
    a0 = pb.add(y3, b0)
    steps["__add_0"] = ((np.asarray(y3.values), y3.scale,
                         np.asarray(b0.values), b0.scale),
                        np.asarray(a0.values), a0.scale)
    p1 = record("max_pool", a0, pb.max_pool(a0, 2, 2))
    record("transition_1", p1, pb.conv_bn(p1, 64, 1, name="transition_1"))
    return steps


STEP_CALLS = {
    "stem_conv": lambda pb, x: pb.conv_bn(x, 8, 3, stride=2,
                                          activation="relu",
                                          name="stem_conv"),
    "stem_depthwise": lambda pb, x: pb.depthwise_conv_bn(
        x, 3, stride=2, activation="relu", name="stem_depthwise"),
    "stem_pointwise": lambda pb, x: pb.conv_bn(x, 32, 1,
                                               name="stem_pointwise"),
    "section_0_block_0": lambda pb, x: pb.binary_conv_bn(
        x, 32, 3, pad_value=1, name="section_0_block_0"),
    "max_pool": lambda pb, x: pb.max_pool(x, 2, 2),
    "transition_1": lambda pb, x: pb.conv_bn(x, 64, 1, name="transition_1"),
}


@pytest.mark.parametrize("name", list(STEP_CALLS))
def test_int8_layer_matches_jax_bit_for_bit(quicknet, jax_steps, name):
    """From the same input (JAX's, int8 with its scale; the float image for
    the stem conv, which quantises on entry) each layer's int8 output and
    scale equal JAX's bit for bit at float32."""
    inp, want, want_scale = jax_steps[name]
    pb = PackedBuilder(layers_from_numpy(quicknet.layers),
                       compute_dtype=torch.float32)
    x = _t8(*inp) if isinstance(inp, tuple) else torch.from_numpy(inp)
    out = STEP_CALLS[name](pb, x)
    assert isinstance(out, Int8Tensor) and out.values.dtype == torch.int8
    assert out.scale == want_scale
    np.testing.assert_array_equal(out.values.numpy(), want)


def test_int8_add_matches_jax_bit_for_bit(quicknet, jax_steps):
    (a, sa, b, sb), want, want_scale = jax_steps["__add_0"]
    pb = PackedBuilder(layers_from_numpy(quicknet.layers))
    out = pb.add(_t8(a, sa), _t8(b, sb))
    assert isinstance(out, Int8Tensor) and out.scale == want_scale
    np.testing.assert_array_equal(out.values.numpy(), want)
    # The second add has another name: a float operand takes the float add.
    mixed = pb.add(_t8(a, sa), _t8(b, sb).to_float())
    assert isinstance(mixed, torch.Tensor) and mixed.dtype == torch.float32


@pytest.mark.parametrize("layer", ["stem_conv", "stem_depthwise",
                                   "transition_1", "head"])
def test_int32_accumulators_match_jax(quicknet, jax_steps, rng, layer):
    """The int32 accumulator of each int8 layer, from its artifact kernel
    and an int8 input of its shape, equals JAX's."""
    k = quicknet.layers[layer]["kernel_int8"]
    kind = quicknet.layers[layer]["kind"]
    if kind == "dense":
        x = _int8(rng, (5, k.shape[0]))
        got = L.dense_int8(torch.from_numpy(x), torch.from_numpy(k))
        want = jax.lax.dot_general(
            jnp.asarray(x), jnp.asarray(k), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
    elif kind == "depthwise_conv":
        c = k.shape[2]
        x = _int8(rng, (2, 16, 16, c))
        got = L.depthwise_conv2d_int8(torch.from_numpy(x),
                                      torch.from_numpy(k), (2, 2))
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k).reshape(3, 3, 1, c), (2, 2),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c, preferred_element_type=jnp.int32)
    else:
        stride = quicknet.layers[layer]["stride"]
        x = _int8(rng, (2, 16, 16, k.shape[2]))
        got = L.conv2d_int8(torch.from_numpy(x), torch.from_numpy(k), stride)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), stride, "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("pool,stride", [(2, 2), (3, 2)])
def test_int8_max_pool_and_flatten_match_jax(rng, pool, stride, padding):
    """All-negative inputs: SAME padding must not bring in a 0."""
    v = -np.abs(_int8(rng, (2, 7, 9, 5))) - 1
    v = v.astype(np.int8)
    jb = JPackedBuilder({}, compute_dtype=jnp.float32)
    pb = PackedBuilder({}, compute_dtype=torch.float32)
    want = jb.max_pool(JInt8Tensor(jnp.asarray(v), 0.5), pool, stride,
                       padding)
    got = pb.max_pool(_t8(v, 0.5), pool, stride, padding)
    assert isinstance(got, Int8Tensor) and got.values.dtype == torch.int8
    assert got.scale == want.scale == 0.5
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.values.max() < 0
    flat = pb.flatten(got)
    jflat = jb.flatten(want)
    assert isinstance(flat, Int8Tensor) and flat.scale == 0.5
    np.testing.assert_array_equal(flat.values.numpy(),
                                  np.asarray(jflat.values))


@pytest.mark.parametrize("activation", [None, "relu", "relu6"])
def test_int8_out_activations_match_jax(rng, activation):
    """relu and relu6 are applied in the quantised domain."""
    acc = rng.integers(-40000, 40000, size=(4, 6), dtype=np.int32)
    a = {"bias": rng.normal(0, 1, 6).astype(np.float32), "out_scale": 0.043}
    scale = rng.uniform(1e-4, 3e-4, 6).astype(np.float32)
    want = JPackedBuilder({})._int8_out(jnp.asarray(acc), jnp.asarray(scale),
                                        a, activation)
    got = PackedBuilder({})._int8_out(
        torch.from_numpy(acc), torch.from_numpy(scale),
        {**a, "bias": torch.from_numpy(a["bias"])}, activation)
    assert got.scale == want.scale
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_int8_out_without_out_scale_is_float(rng):
    acc = rng.integers(-40000, 40000, size=(4, 6), dtype=np.int32)
    a = {"bias": rng.normal(0, 1, 6).astype(np.float32)}
    scale = rng.uniform(1e-4, 3e-4, 6).astype(np.float32)
    want = JPackedBuilder({}, compute_dtype=jnp.float32)._int8_out(
        jnp.asarray(acc), jnp.asarray(scale), a, "relu")
    got = PackedBuilder({}, compute_dtype=torch.float32)._int8_out(
        torch.from_numpy(acc), torch.from_numpy(scale),
        {"bias": torch.from_numpy(a["bias"])}, "relu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unsupported_activation_text_matches_jax():
    acc = np.zeros((1, 2), np.int32)
    a = {"bias": None, "out_scale": 0.1}
    with pytest.raises(ValueError) as jerr:
        JPackedBuilder({})._int8_out(jnp.asarray(acc), 1.0, a, "tanh")
    with pytest.raises(ValueError) as err:
        PackedBuilder({})._int8_out(torch.from_numpy(acc), 1.0, a, "tanh")
    assert str(err.value) == str(jerr.value)
    assert "unsupported activation 'tanh' on an int8-output layer" in str(
        err.value)


# -- the binary conv on and into int8 -------------------------------------------


@pytest.mark.parametrize("kernel", ["bgemm", "reference"])
def test_int8_output_binary_conv_matches_jax(quicknet, jax_steps, kernel):
    """int8 in, int8 out through the binary GEMM's int8 epilogue, against
    JAX's Pallas bgemm (interpret mode) and its packed reference."""
    (v, s), _, _ = jax_steps["section_0_block_0"]
    jpb = JPackedBuilder(quicknet.jlayers, compute_dtype=jnp.float32,
                         kernel=kernel)
    want = jpb.binary_conv_bn(JInt8Tensor(jnp.asarray(v), s), 32, 3,
                              pad_value=1, name="section_0_block_0")
    pb = PackedBuilder(layers_from_numpy(quicknet.layers),
                       compute_dtype=torch.float32)
    got = pb.binary_conv_bn(_t8(v, s), 32, 3, pad_value=1,
                            name="section_0_block_0")
    assert isinstance(got, Int8Tensor) and got.values.dtype == torch.int8
    assert got.scale == want.scale
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def _counting(fn, calls):
    def counted(*a, **kw):
        calls.append(kw.get("out_kind", kw.get("has_residual")))
        return fn(*a, **kw)
    return counted


@pytest.mark.parametrize("x_kind", ["int8", "float"])
def test_int8_binary_conv_never_reaches_the_block_kernel(quicknet, jax_steps,
                                                         x_kind):
    """An int8-output conv takes the GEMM whatever its input; so does a
    float-output conv (no out range) whose input is an Int8Tensor, and it
    equals JAX's."""
    (v, s), _, _ = jax_steps["section_0_block_0"]
    gemms, blocks = [], []
    layers = layers_from_numpy(quicknet.layers)
    kw = dict(compute_dtype=torch.float32,
              gemm=_counting(bgemm_plain, gemms),
              residual_block=_counting(binary_residual_block_plain, blocks))
    x = _t8(v, s)
    out = PackedBuilder(layers, **kw).binary_conv_bn(
        x if x_kind == "int8" else x.to_float(), 32, 3, pad_value=1,
        name="section_0_block_0")
    assert isinstance(out, Int8Tensor)
    assert gemms == ["int8"] and blocks == []
    if x_kind == "float":
        return
    no_out = {k: val for k, val in layers["section_0_block_0"].items()
              if k not in ("out_scale", "int8_multiplier", "int8_bias")}
    out = PackedBuilder({"section_0_block_0": no_out}, **kw).binary_conv_bn(
        x, 32, 3, pad_value=1, name="section_0_block_0")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert gemms == ["int8", "float"] and blocks == []
    jno_out = {k: val for k, val in
               quicknet.jlayers["section_0_block_0"].items() if k in no_out}
    want = JPackedBuilder({"section_0_block_0": jno_out},
                          compute_dtype=jnp.float32,
                          kernel="bgemm").binary_conv_bn(
        JInt8Tensor(jnp.asarray(v), s), 32, 3, pad_value=1,
        name="section_0_block_0")
    # The float epilogue may fuse its multiply-add on JAX's side: one FMA
    # rounding of a product of magnitude up to 2 * 288.
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)


# -- the whole pipeline -----------------------------------------------------------


def test_int8_stream_matches_jax_bit_for_bit(model):
    """The whole forward from the same artifact, float32: every int8 tensor
    of the stream, in order, equals JAX's bit for bit up to the first float
    op (QuickNet: the ReLU before the global average pool; the other model:
    the binary dense's float output). After it the head quantises a float
    whose last bits may differ, so its int8 output may differ by one step in
    a few places and the probabilities are held to atol 2e-2."""
    x = model.x(6)
    jb = JTracing(model.jlayers, compute_dtype=jnp.float32, kernel="mxu")
    want = np.asarray(model.jspec.forward(jb, jnp.asarray(x)))
    pb = Tracing(layers_from_numpy(model.layers),
                 compute_dtype=torch.float32)
    with torch.inference_mode():
        got = model.spec.forward(pb, torch.from_numpy(x)).numpy()
    assert [n for n, _ in pb.stream] == [n for n, _ in jb.stream]
    assert len(pb.stream) >= 5
    for (name, g), (_, w) in zip(pb.stream[:-1], jb.stream[:-1]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    name, g = pb.stream[-1]
    assert name == "head"
    step = np.abs(g.astype(np.int32) - jb.stream[-1][1].astype(np.int32))
    assert step.max() <= 1 and (step != 0).mean() <= 0.05
    np.testing.assert_allclose(got, want, atol=2e-2)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_apply_int8_matches_jax(quicknet, dtype):
    """``packed_apply`` itself on the int8 artifact; the int8 stream does not
    depend on the compute dtype, which only the head's float output has."""
    x = quicknet.x(8)
    want = np.asarray(japply(quicknet.jspec, quicknet.jlayers, jnp.asarray(x),
                             kernel="mxu",
                             compute_dtype=getattr(jnp, dtype)), np.float32)
    got = packed_apply(quicknet.spec, quicknet.layers, x,
                       compute_dtype=getattr(torch, dtype),
                       device="cpu").float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_int8_tail_is_dequantised(quicknet):
    """A model that ends on an int8 layer returns floats."""
    def headless(b, x):
        x = b.conv_bn(x, 8, 3, stride=2, activation="relu", name="stem_conv")
        return b.depthwise_conv_bn(x, 3, stride=2, activation="relu",
                                   name="stem_depthwise")

    x = quicknet.x(2)
    jspec = JModelSpec("h", headless, input_size=(32, 32), num_classes=0)
    spec = ModelSpec("h", headless, input_size=(32, 32), num_classes=0)
    want = np.asarray(japply(jspec, quicknet.jlayers, jnp.asarray(x),
                             compute_dtype=jnp.float32))
    got = packed_apply(spec, quicknet.layers, x, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sixteen_blocks_run_as_int8_gemms_and_int8_adds():
    """The full-depth topology at narrow width: in the int8 pipeline every
    one of the 16 binary convs writes int8 through the GEMM, none reaches
    the block kernel, and all 16 adds run as int8 ADDs; without ranges the
    same model still runs 16 fused blocks."""
    spec = tiny_quicknet(section_filters=(32, 64, 64, 32),
                         section_blocks=(4, 4, 4, 4), num_classes=4,
                         input_size=32)
    params = init_model(spec, seed=0, randomize_bn=True)
    in_r, out_r = calibrate_model(spec, params, _calib(32, n=1),
                                  with_outputs=True, device="cpu")
    assert sum(k.startswith("__add_") for k in out_r) == 16
    layers = convert_model(spec, params, int8_ranges=in_r,
                           int8_out_ranges=out_r)
    x = _calib(32, n=1, batch=2, seed=3)[0]

    adds = []
    add = PackedBuilder.add

    def spy(self, a, b):
        out = add(self, a, b)
        adds.append(type(out).__name__)
        return out

    for converted, want_gemms, want_blocks, want_adds in (
            (layers, ["int8"] * 16, [], ["Int8Tensor"] * 16),
            (convert_model(spec, params), [], [True] * 16, ["Tensor"] * 16)):
        gemms, blocks = [], []
        adds.clear()
        PackedBuilder.add = spy
        try:
            out = packed_apply(
                spec, converted, x, device="cpu",
                gemm=_counting(bgemm_plain, gemms),
                residual_block=_counting(binary_residual_block_plain, blocks))
        finally:
            PackedBuilder.add = add
        assert out.shape == (2, 4) and bool(torch.isfinite(out).all())
        assert (gemms, blocks, adds) == (want_gemms, want_blocks, want_adds)


def test_full_width_quicknet_int8_stream_matches_jax():
    """QuickNet at its full width and depth (224x224x3, 64/128/256/512, 16
    blocks), batch 2, calibrated on one batch of 2 by JAX: all 42 int8
    tensors of the stream equal JAX's bit for bit."""
    from compute_engine_tpu.models import get_model as jget_model

    from compute_engine_tpu_torch.models import get_model

    jspec, spec = jget_model("quicknet"), get_model("quicknet")
    jparams = jinit(jspec, seed=0, randomize_bn=True)
    in_r, out_r = jcalibrate(jspec, jparams, _calib(224, n=1, batch=2),
                             with_outputs=True)
    jlayers = jconvert(jspec, jparams, int8_ranges=in_r,
                       int8_out_ranges=out_r)
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True),
                           int8_ranges=in_r, int8_out_ranges=out_r)
    _assert_layers_equal(layers, jlayers)
    x = _calib(224, n=1, batch=2, seed=7)[0]
    jb = JTracing(jlayers, compute_dtype=jnp.float32, kernel="mxu")
    jspec.forward(jb, jnp.asarray(x))
    pb = Tracing(layers_from_numpy(layers), compute_dtype=torch.float32)
    with torch.inference_mode():
        spec.forward(pb, torch.from_numpy(x))
    names = [n for n, _ in pb.stream]
    assert names == [n for n, _ in jb.stream] and len(names) == 42
    assert names.count("add") == 16 and names.count("max_pool") == 3
    for (name, g), (_, w) in zip(pb.stream[:-1], jb.stream[:-1]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    step = np.abs(pb.stream[-1][1].astype(np.int32)
                  - jb.stream[-1][1].astype(np.int32))
    assert names[-1] == "head" and step.max() <= 1


# -- runtime ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["probs", "logits", "int8"])
def test_interpreter_runs_the_int8_artifact(quicknet, mode):
    x = quicknet.x(5)
    kw = dict(output_mode=mode)
    if mode == "int8":
        kw.update(output_scale=1 / 256.0, output_zero_point=-128)
    want = JInterpreter(quicknet.jspec, quicknet.jlayers,
                        compute_dtype=jnp.float32, **kw).predict(x)
    got = Interpreter(quicknet.spec, quicknet.layers,
                      compute_dtype=torch.float32, device="cpu",
                      **kw).predict(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "int8":
        # 2e-2 in probability is 5.12 steps of 1/256.
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 6
    elif mode == "logits":
        # The head's logits are int8 values times its out_scale: one step.
        step = quicknet.layers["head"]["out_scale"]
        np.testing.assert_allclose(got, want, atol=step * 1.001)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)


def test_benchmark_model_int8_raises_without_the_card(quicknet):
    with pytest.raises(ValueError, match="no CPU mode"):
        benchmark_model(quicknet.spec, batch=1, int8_pipeline=True,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark_model(quicknet.spec, batch=1, int8_pipeline=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calibrate_model(quicknet.spec, quicknet.params, quicknet.calib)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            float_apply(quicknet.spec, quicknet.params, quicknet.x(1))
