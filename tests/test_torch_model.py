"""Tiny QuickNet through both packages: weights, artifact, forward,
Interpreter. The port runs on the CPU with its plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.converter import save_artifact as jsave_artifact
from compute_engine_tpu.models import (
    convert_model as jconvert,
    init_model as jinit,
    packed_apply as japply,
    prepare_runtime_arrays as jprepare,
    tiny_quicknet as jtiny_quicknet,
)
from compute_engine_tpu.runtime import Interpreter as JInterpreter

from compute_engine_tpu_torch.converter import load_artifact, save_artifact
from compute_engine_tpu_torch.interop import (layers_from_numpy,
                                              params_from_numpy)
from compute_engine_tpu_torch.models import (
    convert_model,
    get_model,
    init_model,
    packed_apply,
    prepare_runtime_arrays,
    tiny_quicknet,
)
from compute_engine_tpu_torch.runtime import Interpreter

JSPEC = jtiny_quicknet(num_classes=16)
SPEC = tiny_quicknet(num_classes=16)
SEED = 3


@pytest.fixture(scope="module")
def jax_model():
    params = jinit(JSPEC, seed=SEED, randomize_bn=True)
    return params, jconvert(JSPEC, params)


@pytest.fixture(scope="module")
def port_layers():
    return convert_model(SPEC, init_model(SPEC, seed=SEED, randomize_bn=True))


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
                assert g == v, (name, k)


def _jax_forward(layers, x, kernel, dtype):
    return np.asarray(japply(JSPEC, layers, jnp.asarray(x), kernel=kernel,
                             compute_dtype=dtype), np.float32)


def _port_forward(layers, x, dtype):
    return packed_apply(SPEC, layers, x, compute_dtype=dtype,
                        device="cpu").float().numpy()


@pytest.mark.parametrize("randomize_bn", [False, True])
def test_init_model_matches_jax(randomize_bn):
    want = jinit(JSPEC, seed=SEED, randomize_bn=randomize_bn)
    got = init_model(SPEC, seed=SEED, randomize_bn=randomize_bn)
    assert got.keys() == want.keys()
    for name, p in want.items():
        np.testing.assert_array_equal(got[name]["kernel"].numpy(),
                                      p["kernel"])
        for k, v in p.get("bn", {}).items():
            np.testing.assert_array_equal(got[name]["bn"][k].numpy(), v)


def test_convert_model_matches_jax(jax_model, port_layers):
    _assert_layers_equal(port_layers, jax_model[1])


def test_params_from_numpy_converts_jax_params(jax_model):
    params, layers = jax_model
    _assert_layers_equal(convert_model(SPEC, params_from_numpy(params)),
                         layers)


def test_prepare_runtime_arrays_matches_jax(jax_model, port_layers):
    _assert_layers_equal(prepare_runtime_arrays(port_layers),
                         jprepare(jax_model[1]))


def test_runtime_layers_are_contiguous(port_layers):
    """The CUDA kernel takes contiguous tensors only. The converter's packed
    filters come from a transpose (numpy's packing keeps its order; the
    native host library's does not), so the runtime copy must be C-ordered
    whatever it is given."""
    layers = {name: dict(entry) for name, entry in port_layers.items()}
    block = layers["section_0_block_0"]
    block["packed_filter"] = np.asfortranarray(block["packed_filter"])
    assert not block["packed_filter"].flags["C_CONTIGUOUS"]
    runtime = layers_from_numpy(prepare_runtime_arrays(layers))
    for name, entry in runtime.items():
        for k, v in entry.items():
            if isinstance(v, torch.Tensor):
                assert v.is_contiguous(), (name, k)


@pytest.mark.parametrize("name", ["quicknet", "birealnet18",
                                  "binary_resnet_e18", "binary_densenet28",
                                  "binary_densenet37", "binary_densenet45"])
def test_full_zoo_models_convert_like_jax(name):
    """Shape tracing on the meta device walks every zoo topology at full
    size, producing JAX's layer set and packed shapes."""
    from compute_engine_tpu.models import get_model as jget_model

    want = jconvert(jget_model(name), jinit(jget_model(name), seed=0))
    got = convert_model(get_model(name), init_model(get_model(name), seed=0))
    assert got.keys() == want.keys()
    for lname, entry in want.items():
        for k, v in entry.items():
            if isinstance(v, np.ndarray):
                assert got[lname][k].shape == v.shape, (lname, k)
                assert got[lname][k].dtype == v.dtype, (lname, k)


def test_binary_dense_converts_like_jax():
    """Init and Convert of binary dense layers (BinaryAlexNet's tail)."""
    from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec

    from compute_engine_tpu_torch.models.zoo import ModelSpec

    def bd_model(b, x):
        x = b.conv_bn(x, 16, 3, stride=2, activation="relu", name="stem")
        x = b.binary_conv_bn(x, 32, 3, pad_value=1, name="bconv")
        x = b.max_pool(x, 3, 2, padding="VALID")
        x = b.flatten(x)
        x = b.binary_dense_bn(x, 40, name="bfc")
        x = b.dense(x, 10, name="head")
        return b.softmax(x)

    jspec = JModelSpec("bd", bd_model, input_size=(16, 16), num_classes=10)
    spec = ModelSpec("bd", bd_model, input_size=(16, 16), num_classes=10)
    want = jprepare(jconvert(jspec, jinit(jspec, seed=1, randomize_bn=True)))
    got = prepare_runtime_arrays(convert_model(
        spec, init_model(spec, seed=1, randomize_bn=True)))
    _assert_layers_equal(got, want)
    # The binary dense runs (quantize -> bgemm) and matches JAX's forward.
    x = np.random.default_rng(1).normal(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    want_y = np.asarray(japply(jspec, want, jnp.asarray(x), kernel="mxu",
                               compute_dtype=jnp.float32))
    got_y = packed_apply(spec, got, x, compute_dtype=torch.float32,
                         device="cpu").numpy()
    np.testing.assert_allclose(got_y, want_y, atol=1e-3)


def test_jax_artifact_loads_in_port(tmp_path, jax_model, rng):
    path = str(tmp_path / "tiny.npz")
    jsave_artifact(path, jax_model[1], JSPEC.name, {"input_size": [32, 32]})
    name, config, loaded = load_artifact(path)
    assert name == JSPEC.name and config == {"input_size": [32, 32]}
    runtime = layers_from_numpy(loaded)
    assert runtime["section_0_block_0"]["packed_filter"].dtype == torch.int32
    np.testing.assert_array_equal(
        runtime["section_0_block_0"]["packed_filter"].numpy().view(np.uint32),
        jax_model[1]["section_0_block_0"]["packed_filter"])
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _port_forward(runtime, x, torch.float32),
        _port_forward(jax_model[1], x, torch.float32))


def test_port_artifact_roundtrip(tmp_path, port_layers):
    path = str(tmp_path / "port.npz")
    save_artifact(path, port_layers, SPEC.name)
    _, _, loaded = load_artifact(path)
    for name, entry in port_layers.items():
        for k, v in entry.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(loaded[name][k], v)
            elif isinstance(v, tuple):
                assert tuple(loaded[name][k]) == v
            else:
                assert loaded[name][k] == v


@pytest.mark.parametrize("kernel", ["auto", "residual"])
def test_forward_float32_matches_jax(jax_model, port_layers, rng, kernel):
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    want = _jax_forward(jax_model[1], x, kernel, jnp.float32)
    got = _port_forward(port_layers, x, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("kernel", ["auto", "residual"])
def test_forward_bf16_matches_jax(jax_model, port_layers, rng, kernel):
    """bf16 activation stream: the two frameworks round at slightly
    different places, so the check is top-1 on every sample plus the loose
    allclose that tests/test_models.py applies to bf16 against fp32."""
    x = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    want = _jax_forward(jax_model[1], x, kernel, jnp.bfloat16)
    got = _port_forward(port_layers, x, torch.bfloat16)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.1)


def _small_bireal(b, x):
    from compute_engine_tpu_torch.models.zoo import birealnet18

    return birealnet18(b, x, num_classes=10)


def _tiny_densenet(b, x):
    from compute_engine_tpu_torch.models.zoo import _binary_densenet_forward

    return _binary_densenet_forward(b, x, layers_per_block=(2, 2),
                                    reductions=(2.0,), growth_rate=32,
                                    initial_filters=32, num_classes=10)


@pytest.mark.parametrize("forward,size", [(_small_bireal, 64),
                                          (_tiny_densenet, 32)])
def test_other_topologies_match_jax_on_cpu(rng, forward, size):
    """On the CPU the plain versions cover every binary conv: zero padding,
    stride 2 (Bi-RealNet), concat growth and average pools (DenseNet)."""
    from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec

    from compute_engine_tpu_torch.models.zoo import ModelSpec

    jspec = JModelSpec("m", forward, input_size=(size, size), num_classes=10)
    spec = ModelSpec("m", forward, input_size=(size, size), num_classes=10)
    layers = jconvert(jspec, jinit(jspec, seed=1, randomize_bn=True))
    x = rng.normal(0, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(japply(jspec, layers, jnp.asarray(x), kernel="mxu",
                             compute_dtype=jnp.float32))
    got = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                       device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_densenet_counts_one_concatenation_a_dense_layer(monkeypatch):
    """``PackedBuilder`` counts each concatenation it launches in
    ``concat.launches``, eagerly, and into the ledger under
    ``counts.recording`` (what a capture records and a replay adds); those
    done in place also in ``concat.in_place``: here all four."""
    from compute_engine_tpu_torch.kernels import counts
    from compute_engine_tpu_torch.models.builder import concat
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("m", _tiny_densenet, input_size=(32, 32),
                     num_classes=10)
    layers = convert_model(spec, init_model(spec, seed=0))
    x = np.zeros((2, 32, 32, 3), np.float32)
    monkeypatch.setattr(concat, "launches", 0)
    monkeypatch.setattr(concat, "in_place", 0)
    packed_apply(spec, layers, x, device="cpu")
    assert (concat.launches, concat.in_place) == (4, 4)
    with counts.recording() as ledger:
        packed_apply(spec, layers, x, device="cpu")
    assert ledger == {(concat, "launches"): 4, (concat, "in_place"): 4}
    assert (concat.launches, concat.in_place) == (4, 4)


@pytest.mark.parametrize("batch,size", [(2, 32), (1, 8)])
@pytest.mark.parametrize("compute_dtype,kernel", [
    (torch.bfloat16, "auto"), (torch.float32, "auto"),
    (torch.bfloat16, "mxu")])
def test_densenet_concatenates_in_place(monkeypatch, rng, compute_dtype,
                                        kernel, batch, size):
    """Each dense block's stream lies in one buffer as wide as the block's
    final width (``PackedBuilder.dense_block``): every layer's block reads
    the stream where it lies and writes its channels after it, so all four
    concatenations of the tiny DenseNet are in place (``concat.in_place`` ==
    ``concat.launches``) and its logits equal, bit for bit, those of the
    same forward with in-place concatenation unavailable (``torch.cat`` at
    every layer). Under ``kernel="mxu"`` no block runs: each concatenation
    is a ``torch.cat``, none in place, the logits the same. At batch 1 on
    8x8 images the second block's stream is one pixel, whose channel
    prefix PyTorch counts as dense."""
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)
    from compute_engine_tpu_torch.models.builder import (PackedBuilder,
                                                         _Base, concat)
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("m", _tiny_densenet, input_size=(size, size),
                     num_classes=10)
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    x = rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32)
    logits, seen = [], []

    def block(x, *a, out=None, **kw):
        seen[-1].append(out is not None)
        return binary_residual_block_plain(x, *a, out=out, **kw)

    for in_place in (True, False):
        if not in_place:
            monkeypatch.setattr(PackedBuilder, "dense_block",
                                _Base.dense_block)
        monkeypatch.setattr(concat, "launches", 0)
        monkeypatch.setattr(concat, "in_place", 0)
        seen.append([])
        logits.append(packed_apply(spec, layers, x, kernel=kernel,
                                   device="cpu", compute_dtype=compute_dtype,
                                   return_logits=True, residual_block=block))
        blocks = kernel == "auto"
        assert (concat.launches, concat.in_place) == (
            4, 4 if in_place and blocks else 0)
    assert seen == ([[True] * 4, [False] * 4] if blocks else [[], []])
    assert torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("pipeline", ["int8", "packed"])
def test_densenet_dense_block_keeps_the_other_pipelines(monkeypatch, rng,
                                                        pipeline):
    """The true-int8 pipeline (its stream an ``Int8Tensor``, which has no
    shape) and the packed domain (its dense layers packed streams) run the
    tiny DenseNet with the dense block declared: each of the four
    concatenations is a ``torch.cat``, none in place, and the logits equal
    those with ``dense_block`` the no-op."""
    from compute_engine_tpu_torch.models import calibrate_model
    from compute_engine_tpu_torch.models.builder import (PackedBuilder,
                                                         _Base, concat)
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("m", _tiny_densenet, input_size=(32, 32),
                     num_classes=10)
    params = init_model(spec, seed=0, randomize_bn=True)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    kw = {}
    if pipeline == "int8":
        in_r, out_r = calibrate_model(spec, params, [x], with_outputs=True,
                                      device="cpu")
        layers = convert_model(spec, params, int8_ranges=in_r,
                               int8_out_ranges=out_r)
    else:
        layers, kw = convert_model(spec, params), {"domain": "packed"}
    logits = []
    for declared in (True, False):
        if not declared:
            monkeypatch.setattr(PackedBuilder, "dense_block",
                                _Base.dense_block)
        monkeypatch.setattr(concat, "launches", 0)
        monkeypatch.setattr(concat, "in_place", 0)
        logits.append(packed_apply(spec, layers, x, device="cpu",
                                   return_logits=True, **kw))
        assert (concat.launches, concat.in_place) == (4, 0)
    assert torch.equal(logits[0], logits[1])


def test_densenet_in_place_replays_under_the_card_standins(monkeypatch, rng):
    """Under the card stand-ins (a captured graph, replayed on the same
    tensors), the tiny DenseNet's compiled forward equals its eager one, and
    one replay counts four concatenations, all in place: the buffers and
    slots the capture wrote are the ones the replay writes."""
    import _torch_card_standins as standins

    from compute_engine_tpu_torch.models.builder import concat
    from compute_engine_tpu_torch.models.zoo import ModelSpec
    from compute_engine_tpu_torch.runtime.compiled import CompiledForward

    standins.install(monkeypatch)
    spec = ModelSpec("m", _tiny_densenet, input_size=(32, 32),
                     num_classes=10)
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    interp = Interpreter(spec, layers, device="cpu", output_mode="logits")
    xs = [rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
          for _ in range(2)]
    want = [interp(x) for x in xs]
    interp._compiled = CompiledForward(interp._forward, torch.device("cpu"))
    interp(xs[1])  # warms up, captures
    monkeypatch.setattr(concat, "launches", 0)
    monkeypatch.setattr(concat, "in_place", 0)
    got = [interp(x) for x in xs]
    assert (concat.launches, concat.in_place) == (8, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_binary_densenet45_takes_num_classes():
    """``binary_densenet45(num_classes=16)``: a 16-way head, 16 logits."""
    import functools

    from compute_engine_tpu_torch.models.zoo import (ModelSpec,
                                                     binary_densenet45)

    spec = ModelSpec("m", functools.partial(binary_densenet45,
                                            num_classes=16),
                     input_size=(32, 32), num_classes=16)
    params = init_model(spec, seed=0)
    assert tuple(params["head"]["kernel"].shape) == (800, 16)
    out = packed_apply(spec, convert_model(spec, params),
                       np.zeros((2, 32, 32, 3), np.float32), device="cpu")
    assert out.shape == (2, 16)


def test_forward_runs_sixteen_blocks_fused(monkeypatch):
    """Every QuickNet block goes through the residual block entry point, with
    its residual add (counted here through a wrapper of the plain version)."""
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)

    calls = []

    def block(*a, has_residual=True, **kw):
        calls.append(has_residual)
        return binary_residual_block_plain(*a, has_residual=has_residual, **kw)

    spec = tiny_quicknet(section_filters=(32, 64, 64, 32),
                         section_blocks=(4, 4, 4, 4), num_classes=4,
                         input_size=16)
    layers = convert_model(spec, init_model(spec, seed=0))
    x = np.zeros((1, 16, 16, 3), np.float32)
    out = packed_apply(spec, layers, x, device="cpu", residual_block=block)
    assert out.shape == (1, 4)
    assert calls == [True] * 16


def test_interpreter_matches_jax(jax_model, port_layers, rng):
    x = rng.normal(0, 1, (5, 32, 32, 3)).astype(np.float32)
    for mode in ("probs", "logits"):
        want = JInterpreter(JSPEC, jax_model[1], compute_dtype=jnp.float32,
                            output_mode=mode).predict(x)
        interp = Interpreter(SPEC, port_layers, compute_dtype=torch.float32,
                             output_mode=mode, device="cpu")
        got = interp.predict(x)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
        assert (got.argmax(-1) == want.argmax(-1)).all()
        # Chunked predict pads the last chunk and must agree.
        # float32 sums reorder with the batch size.
        np.testing.assert_allclose(interp.predict(x, batch_size=2), got,
                                   rtol=1e-5, atol=1e-5)
        single = interp.predict(x[0])
        assert single.shape == (16,)
        np.testing.assert_allclose(single, got[0], rtol=1e-5, atol=1e-5)


def test_interpreter_int8_io_matches_jax(jax_model, port_layers, rng):
    scale = 1 / 127.0
    x8 = np.clip(np.round(rng.uniform(-1, 1, (2, 32, 32, 3)) / scale),
                 -128, 127).astype(np.int8)
    kw = dict(compute_dtype=jnp.float32, input_scale=scale,
              input_zero_point=0, output_mode="int8", output_scale=1 / 256.0,
              output_zero_point=-128)
    want = JInterpreter(JSPEC, jax_model[1], **kw).predict(x8)
    kw["compute_dtype"] = torch.float32
    got = Interpreter(SPEC, port_layers, device="cpu", **kw).predict(x8)
    assert got.dtype == np.int8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_interpreter_introspection_and_validation(port_layers):
    i = Interpreter(SPEC, port_layers, device="cpu")
    assert i.input_shape == (None, 32, 32, 3)
    assert i.output_shape == (None, 16)
    assert i.input_type == np.float32 and i.output_type == np.float32
    assert i.input_scales == [None] and i.output_scales == [None]
    i8 = Interpreter(SPEC, port_layers, input_scale=1 / 64.0,
                     input_zero_point=3, output_mode="int8",
                     output_scale=1 / 127.0, device="cpu")
    assert i8.input_type == np.int8 and i8.output_type == np.int8
    assert i8.input_zero_points == [3] and i8.output_scales == [1 / 127.0]
    with pytest.raises(ValueError, match="output_mode"):
        Interpreter(SPEC, port_layers, output_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="output_scale"):
        Interpreter(SPEC, port_layers, output_mode="int8", device="cpu")


def test_interpreter_from_artifact_path(tmp_path, port_layers, rng):
    path = str(tmp_path / "m.npz")
    spec = tiny_quicknet(num_classes=16)
    save_artifact(path, port_layers, spec.name)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    a = Interpreter(spec, artifact_path=path, device="cpu").predict(x)
    b = Interpreter(spec, port_layers, device="cpu").predict(x)
    np.testing.assert_array_equal(a, b)


# -- Bi-RealNet-18's zero-padded convs on the block kernel ---------------------


@pytest.fixture(scope="module")
def bireal():
    from compute_engine_tpu.models import get_model as jget_model

    jspec = jget_model("birealnet18")
    return jspec, get_model("birealnet18"), jconvert(
        jspec, jinit(jspec, seed=1, randomize_bn=True))


def test_birealnet_auto_takes_the_block_and_matches_jax(bireal, rng):
    """Full-size Bi-RealNet-18 under kernel="auto" at batch 1: its 13
    zero-padded stride-1 convs go through the block entry (the plain
    version on the CPU) with the runtime's correction table, and the
    probabilities stay within C.5's tolerance of JAX's forward, top-1
    equal."""
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)

    from _torch_parity import FLOAT32_MODEL_TOL, assert_outputs_close

    jspec, spec, layers = bireal
    calls = []

    def block(x, pf, tr, params, **kw):
        calls.append((params.pad_value, kw["tap_delta"].shape))
        return binary_residual_block_plain(x, pf, tr, params, **kw)

    x = rng.normal(0, 1, (1, 224, 224, 3)).astype(np.float32)
    got = packed_apply(spec, prepare_runtime_arrays(layers), x,
                       compute_dtype=torch.float32, device="cpu",
                       residual_block=block)
    want = japply(jspec, layers, jnp.asarray(x), kernel="mxu",
                  compute_dtype=jnp.float32)
    assert [p for p, _ in calls] == [0] * 13
    assert all(shape[1] == 9 for _, shape in calls)
    assert_outputs_close(got, want, **FLOAT32_MODEL_TOL)


def test_compiled_forward_counts_zero_padded_block_launches(monkeypatch):
    """Under the card stand-ins (a captured graph, replayed), one Bi-RealNet
    forward at batch 1 counts 13 block launches, all zero-padded, and no
    GEMM launch; QuickNet's 16 one-padded launches are as they were. The
    kernels' launches are stood in for by their plain versions, counted as
    the wrappers count a launch."""
    import _torch_card_standins as standins

    from compute_engine_tpu_torch.kernels import bgemm as bgemm_mod
    from compute_engine_tpu_torch.kernels import counts, residual
    from compute_engine_tpu_torch.runtime.compiled import CompiledForward

    standins.install(monkeypatch)
    block_plain, gemm_plain = (residual.binary_residual_block_plain,
                               bgemm_mod.bgemm_plain)

    def block_launch(x, pf, tr, params, *a, **kw):
        residual._count_launch(params.pad_value == 0)
        return block_plain(x, pf, tr, params, *a, **kw)

    def gemm_launch(*a, **kw):
        counts.count(bgemm_mod.bgemm)
        return gemm_plain(*a, **kw)

    monkeypatch.setattr(residual, "binary_residual_block_plain",
                        block_launch)
    monkeypatch.setattr(bgemm_mod, "bgemm_plain", gemm_launch)
    block, gemm = residual.binary_residual_block, bgemm_mod.bgemm
    x = np.random.default_rng(7).normal(0, 1, (1, 224, 224, 3)).astype(
        np.float32)
    for name, want in (("birealnet18", (13, 13, 0)), ("quicknet", (16, 0, 0))):
        spec = get_model(name)
        interp = Interpreter(spec, convert_model(spec, init_model(spec,
                                                                  seed=0)),
                             device="cpu")
        interp._compiled = CompiledForward(interp._forward,
                                           torch.device("cpu"))
        interp(x)  # warms up, captures
        for fn, attr in ((block, "launches"), (block, "zero_pad_launches"),
                         (gemm, "launches")):
            monkeypatch.setattr(fn, attr, 0)
        interp(x)  # one replay
        assert (block.launches, block.zero_pad_launches,
                gemm.launches) == want, name
