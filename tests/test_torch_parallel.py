"""The port's multi-device layer (``compute_engine_tpu_torch.parallel``) on
eight ``cpu`` slots, against the JAX package on the 8-device CPU mesh that
``conftest.py`` forces: mesh construction, the sharding spec tree, sharded
placement, the sharded forward, and ``tp_bconv2d`` in its three modes.

Tolerances: the sharded forward against JAX's jitted sharded
``packed_apply`` within ``FLOAT32_MODEL_TOL`` with equal top-1 (the float
layers of the two packages round in different places), and within 1e-5 of
the port's own unsharded forward (a float layer computed on a channel
slice may round its last bit differently). ``tp_bconv2d``: bits equal to
JAX's; floats within one FMA rounding of the epilogue
(``kernels/residual.py:25-30`` of the JAX package: rtol 2e-5, atol 2e-4);
int8 equal to JAX's single-device op and within that rounding (one step)
of its jitted ``tp_bconv2d`` (``_jax_tp``). Every mode's output is also
``torch.equal`` to the port's single-slot ``ops.bconv2d``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compute_engine_tpu.core import OutputTransform as JOutputTransform
from compute_engine_tpu.core import bitpack as jbitpack
from compute_engine_tpu.core import (compute_output_thresholds as
                                     jcompute_output_thresholds)
from compute_engine_tpu.core import fuse_output_transform as jfuse
from compute_engine_tpu.core.params import BConv2DParams as JParams
from compute_engine_tpu.core.types import Padding as JPadding
from compute_engine_tpu.models import convert_model as jconvert
from compute_engine_tpu.ops import bconv2d as jbconv2d
from compute_engine_tpu.models import init_model as jinit
from compute_engine_tpu.models import packed_apply as japply
from compute_engine_tpu.models import prepare_runtime_arrays as jprepare
from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet
from compute_engine_tpu.parallel import artifact_shardings as jshardings
from compute_engine_tpu.parallel import input_sharding as jinput_sharding
from compute_engine_tpu.parallel import make_mesh as jmake_mesh
from compute_engine_tpu.parallel import shard_artifact as jshard_artifact
from compute_engine_tpu.parallel import tp_bconv2d as jtp_bconv2d

from compute_engine_tpu_torch.core import (BConv2DParams, OutputTransform,
                                           Padding, bitpack)
from compute_engine_tpu_torch.core.transforms import (
    compute_output_thresholds, fuse_output_transform)
from compute_engine_tpu_torch.models import (calibrate_model, convert_model,
                                             init_model, packed_apply,
                                             prepare_runtime_arrays,
                                             tiny_quicknet)
from compute_engine_tpu_torch.ops import bconv2d
from compute_engine_tpu_torch.parallel import (artifact_shardings,
                                               input_sharding, make_mesh,
                                               shard_artifact, tp_bconv2d)
from compute_engine_tpu_torch.parallel.partition import (sharded_apply,
                                                         shards_layer)
from compute_engine_tpu_torch.parallel.sharding import (NamedSharding,
                                                        device_put)

import _torch_parity as parity

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
CPU8 = ["cpu"] * 8
FLOAT_TOL = dict(rtol=2e-5, atol=2e-4)  # one FMA rounding of the epilogue
# Ten classes: the dense head is replicated at 4 and 8 model slots
# (``_fit_spec``), sharded at 2.
TINY = dict(section_filters=(32, 64), section_blocks=(1, 1), num_classes=10,
            input_size=32)


@pytest.fixture(scope="module")
def tiny():
    spec = tiny_quicknet(**TINY)
    jspec = jtiny_quicknet(**TINY)
    layers = convert_model(spec, init_model(spec, seed=3, randomize_bn=True))
    jlayers = jconvert(jspec, jinit(jspec, seed=3, randomize_bn=True))
    x = parity.images(5, 8)
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu")
    return spec, jspec, layers, jlayers, x, want


# -- mesh --------------------------------------------------------------------


def test_make_mesh_shapes():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"data": 8, "model": 1}
    assert mesh.axis_names == ("data", "model")
    mesh = make_mesh((2, 4), devices=CPU8)
    assert mesh.shape["data"] == 2 and mesh.shape["model"] == 4
    assert mesh.devices.shape == (2, 4) and mesh.devices.size == 8
    assert set(mesh.devices.ravel()) == {torch.device("cpu")}
    assert [idx for idx, _ in mesh.slots()][:3] == [(0, 0), (0, 1), (0, 2)]
    with mesh as entered:
        assert entered is mesh
    jmesh = jmake_mesh((2, 4))
    assert dict(jmesh.shape) == mesh.shape
    assert tuple(jmesh.axis_names) == mesh.axis_names


def test_make_mesh_rejects_a_shape_that_does_not_cover_its_devices():
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        make_mesh((3, 2), devices=CPU8)
    with pytest.raises(ValueError, match="does not cover"):
        jmake_mesh((3, 2))


# -- sharding ----------------------------------------------------------------


def _spec_tree(shardings):
    return {layer: {k: tuple(sh.spec) for k, sh in arrays.items()}
            for layer, arrays in shardings.items()}


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_artifact_shardings_match_jax(tiny, mesh_shape):
    """The spec tree letter for letter, ``_fit_spec``'s replication of the
    ten-class head at 4 and 8 model slots included."""
    _, _, layers, jlayers, _, _ = tiny
    got = _spec_tree(artifact_shardings(
        prepare_runtime_arrays(layers), make_mesh(mesh_shape, devices=CPU8)))
    want = _spec_tree(jshardings(jprepare(jlayers), jmake_mesh(mesh_shape)))
    assert got == want
    assert got["head"]["kernel"] == ((None, "model") if mesh_shape[1] in (1, 2)
                                     else (None, None))
    assert input_sharding(make_mesh(mesh_shape, devices=CPU8)).spec == tuple(
        jinput_sharding(jmake_mesh(mesh_shape)).spec)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_shard_artifact_slices_join_back(tiny, mesh_shape):
    """Every slot holds its block of each array; joined back they are the
    arrays (packed words viewed as int32), and a slot's block of a sharded
    filter is 1/tp of it."""
    _, _, layers, _, _, _ = tiny
    mesh = make_mesh(mesh_shape, devices=CPU8)
    runtime = prepare_runtime_arrays(layers)
    sharded = shard_artifact(runtime, mesh)
    tp = mesh_shape[1]
    for name, layer in runtime.items():
        for k, v in layer.items():
            if not isinstance(v, np.ndarray):
                assert sharded[name][k] == v
                continue
            st = sharded[name][k]
            want = v.view(np.int32) if v.dtype == np.uint32 else v
            np.testing.assert_array_equal(st.join().numpy(), want)
            if "model" in st.spec:
                dim = st.spec.index("model")
                assert st.shards[1].shape[dim] * tp == v.shape[dim]


def test_device_put_refuses_an_uneven_split():
    mesh = make_mesh((1, 8), devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        device_put(np.zeros(10, np.float32), NamedSharding(mesh, ("model",)))


# -- the sharded forward -----------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_forward_matches_jax_and_unsharded(tiny, mesh_shape):
    spec, jspec, layers, jlayers, x, want = tiny
    jmesh = jmake_mesh(mesh_shape)
    with jmesh:
        jsharded = jshard_artifact(jlayers, jmesh)
        xs = jax.device_put(x, jinput_sharding(jmesh))
        jwant = np.asarray(jax.jit(lambda t: japply(
            jspec, jsharded, t, compute_dtype=jnp.float32))(xs))
    mesh = make_mesh(mesh_shape, devices=CPU8)
    log = []
    got = sharded_apply(spec, shard_artifact(prepare_runtime_arrays(layers),
                                             mesh),
                        x, mesh, compute_dtype=torch.float32, log=log)
    parity.assert_outputs_close(got, jwant, **parity.FLOAT32_MODEL_TOL)
    parity.assert_outputs_close(got, want, atol=1e-5)
    kinds = {r["kind"] for r in log}
    assert kinds == (set() if mesh_shape[1] == 1
                     else {"broadcast", "all_gather"})
    assert all(r["local"] for r in log)  # eight slots of one device


def _mini_alexnet(b, x, num_classes=10):
    """BinaryAlexNet's packed-domain chain at toy scale
    (tests/test_torch_packed_domain.py)."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 2, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 128, name="fc1")
    x = b.binary_dense_bn(x, 128, name="fc2")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def _zero_padded_blocks(b, x, num_classes=10):
    """Two zero-padded residual blocks and a zero-padded conv whose consumer
    is not its add, as Bi-RealNet's convs are zero-padded."""
    x = b.conv_bn(x, 64, 3, stride=2, name="stem")
    x = b.add(x, b.binary_conv_bn(x, 64, 3, pad_value=0, name="block1"))
    x = b.add(x, b.binary_conv_bn(x, 64, 3, pad_value=0, name="block2"))
    x = b.binary_conv_bn(x, 128, 3, pad_value=0, name="widen")
    x = b.global_avg_pool(x)
    return b.softmax(b.dense(x, num_classes, name="head"))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 4)])
def test_sharded_zero_padded_blocks_take_their_slots_correction(mesh_shape):
    """Each model slot runs the block entry without the add on its share of
    the output channels, with the rows of zero padding's correction table
    that belong to its slice of the filter; the forward equals the
    unsharded one."""
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("zero_padded", _zero_padded_blocks, input_size=(16, 16),
                     num_classes=10)
    layers = convert_model(spec, init_model(spec, seed=4, randomize_bn=True))
    x = parity.images(10, 4, size=(16, 16))
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu")
    shares = []

    def block(x, pf, tr, params, **kw):
        assert torch.equal(kw["tap_delta"], zero_padding_tap_delta(pf, params))
        shares.append(pf.shape[0])
        return binary_residual_block_plain(x, pf, tr, params, **kw)

    mesh = make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    got = sharded_apply(spec, shard_artifact(prepare_runtime_arrays(layers),
                                             mesh),
                        x, mesh, compute_dtype=torch.float32,
                        residual_block=block)
    parity.assert_outputs_close(got, want, atol=1e-5)
    tp = mesh_shape[1]
    assert sorted(set(shares)) == sorted({64 // tp, 128 // tp})
    assert len(shares) == 3 * tp * mesh_shape[0]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 4)])
def test_sharded_packed_domain_matches_unsharded(mesh_shape):
    """The packed domain over the model slots: a layer whose slot slices
    are whole words (64 / 2, 128 / 4) is gathered word for word, one that
    is not (96 / 2 = 48 channels, 64 / 4 = 16) runs replicated; either way
    the forward equals the unsharded one."""
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("mini_alexnet", _mini_alexnet, input_size=(64, 64),
                     num_classes=10)
    layers = convert_model(spec, init_model(spec, seed=2, randomize_bn=True))
    x = parity.images(9, 4, size=(64, 64))
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu", domain="packed")
    mesh = make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    got = sharded_apply(spec, shard_artifact(prepare_runtime_arrays(layers),
                                             mesh),
                        x, mesh, compute_dtype=torch.float32,
                        domain="packed")
    parity.assert_outputs_close(got, want, atol=1e-5)
    assert shards_layer(64, 2, "bitpacked") and shards_layer(
        128, 4, "bitpacked")
    assert not shards_layer(96, 2, "bitpacked") and not shards_layer(
        64, 4, "bitpacked")
    assert shards_layer(96, 4) and not shards_layer(10, 4)


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("case, mesh_shape, replicated", [
    ("tiny", (1, 8), set()), ("tiny", (4, 2), set()),
    ("mini_alexnet", (1, 2), {"conv3"})])
def test_home_slot_holds_its_share_of_the_weights(tiny, case, mesh_shape,
                                                  replicated):
    """Under tp > 1 a group's home slot holds its own block of every array
    the specs shard, as GSPMD's layout gives each device 1/tp of them, and
    assembles an array whole only for a layer that runs replicated: none of
    the tiny QuickNet's in the float domain; in the packed domain
    mini-AlexNet's conv3, whose 48-channel slices are not whole words."""
    from compute_engine_tpu_torch.models.zoo import ModelSpec
    from compute_engine_tpu_torch.parallel.partition import partition_layers
    from compute_engine_tpu_torch.parallel.sharding import ShardedTensor

    if case == "tiny":
        spec, _, layers, _, x, want = tiny
        domain = "float"
    else:
        spec = ModelSpec("mini_alexnet", _mini_alexnet, input_size=(64, 64),
                         num_classes=10)
        layers = convert_model(spec, init_model(spec, seed=2,
                                                randomize_bn=True))
        x = parity.images(9, 4, size=(64, 64))
        domain = "packed"
        want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                            device="cpu", domain=domain)
    mesh = make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    sharded = shard_artifact(prepare_runtime_arrays(layers), mesh)
    groups = partition_layers(sharded, mesh)
    got = sharded_apply(spec, sharded, x, mesh, compute_dtype=torch.float32,
                        domain=domain, groups=groups)
    parity.assert_outputs_close(got, want, atol=1e-5)
    arrays = [v for layer in sharded.values() for v in layer.values()
              if isinstance(v, ShardedTensor)]
    whole = sum(_nbytes(v.join()) for v in arrays)
    model = sum(_nbytes(v.join()) for v in arrays if "model" in v.spec)
    tp = mesh_shape[1]
    for g in groups:
        joined = g.joined()
        assert set(joined) == replicated
        own = sum(_nbytes(v.shard(g.coords[0])) for v in arrays)
        assert own == whole - model + model // tp
        held = own + sum(_nbytes(t) for a in joined.values()
                         for t in a.values())
        assert held < whole


def test_int8_artifact_runs_its_int8_layers_replicated():
    """An artifact of the true-int8 pipeline under tp = 2: its int8 layers
    run replicated on each group's first slot and the forward equals the
    unsharded one."""
    spec = tiny_quicknet(**TINY)
    params = init_model(spec, seed=4, randomize_bn=True)
    calib = [parity.images(s, 4) for s in (11, 12)]
    ranges, out_ranges = calibrate_model(spec, params, calib,
                                         with_outputs=True, device="cpu")
    layers = convert_model(spec, params, int8_ranges=ranges,
                           int8_out_ranges=out_ranges)
    assert any("kernel_int8" in a for a in layers.values())
    x = parity.images(13, 4)
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu")
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    log = []
    got = sharded_apply(spec, shard_artifact(prepare_runtime_arrays(layers),
                                             mesh),
                        x, mesh, compute_dtype=torch.float32, log=log)
    parity.assert_outputs_close(got, want, atol=1e-5)


def _binary_trunk(b, x):
    """Ends on a binary layer: in the packed domain, its packed words."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv1")
    return b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")


def _int8_trunk(b, x):
    """Ends on an int8 layer of the true-int8 pipeline."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.binary_conv_bn(x, 32, 3, pad_value=1, name="conv1")
    return b.conv_bn(x, 16, 1, name="out")


def _deferred_trunk(b, x):
    """Ends on a block-kernel conv that waits for a consumer it never
    gets."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    return b.binary_conv_bn(x, 32, 3, pad_value=1, name="conv1")


def _tiny_densenet(b, x):
    from compute_engine_tpu_torch.models.zoo import _binary_densenet_forward

    return _binary_densenet_forward(b, x, layers_per_block=(2, 2),
                                    reductions=(2.0,), growth_rate=32,
                                    initial_filters=32, num_classes=10)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1)])
@pytest.mark.parametrize("forward, ends_on, domain, int8, out", [
    (_binary_trunk, "_BinaryStream", "packed", False, (torch.int32, 2)),
    (_int8_trunk, "Int8Tensor", "float", True, (torch.float32, 16)),
    (_deferred_trunk, "_DeferredBConv", "float", False, (torch.float32, 32)),
    (_tiny_densenet, "Tensor", "float", False, (torch.float32, 10))])
def test_sharded_apply_returns_what_packed_apply_returns(
        forward, ends_on, domain, int8, out, mesh_shape):
    """Whatever the forward's last value is (a packed stream, an int8
    tensor, a deferred conv, a tensor), ``sharded_apply`` over data groups
    returns what ``packed_apply`` returns: the packed words, the
    dequantised floats, the conv's output, the logits, bit for bit."""
    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.models import builder as B
    from compute_engine_tpu_torch.models.zoo import ModelSpec

    spec = ModelSpec("m", forward, input_size=(16, 16), num_classes=10)
    params = init_model(spec, seed=5, randomize_bn=True)
    x = parity.images(14, 4, size=(16, 16))
    ranges = (calibrate_model(spec, params, [x], with_outputs=True,
                              device="cpu") if int8 else (None, None))
    layers = prepare_runtime_arrays(convert_model(spec, params, *ranges))
    kw = dict(compute_dtype=torch.float32, domain=domain)
    with torch.inference_mode():
        last = forward(B.PackedBuilder(layers_from_numpy(layers, "cpu"), **kw),
                       torch.from_numpy(x))
    assert type(last).__name__ == ends_on
    want = packed_apply(spec, layers, x, device="cpu", **kw)
    assert (want.dtype, want.shape[-1]) == out
    mesh = make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    got = sharded_apply(spec, shard_artifact(layers, mesh), x, mesh, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_sharded_forward_refuses_a_batch_the_data_axis_does_not_divide(
        tiny):
    spec, _, layers, _, _, _ = tiny
    mesh = make_mesh((4, 2), devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_apply(spec, shard_artifact(prepare_runtime_arrays(layers),
                                           mesh),
                      parity.images(1, 6), mesh)


# -- tp_bconv2d --------------------------------------------------------------


def _tp_case(output_kind, batch, seed=42, c_in=64, c_out=256):
    """One binary conv in both packages, from the same numpy draws
    (``tests/test_parallel.py``'s construction)."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.0, 1.0], np.float32),
                   size=(batch, 8, 8, c_in))
    w = rng.choice(np.array([-1.0, 1.0], np.float32),
                   size=(c_out, 3, 3, c_in))
    post_mul = (rng.uniform(0.2, 2.0, c_out)
                * rng.choice([-1.0, 1.0], c_out)).astype(np.float32)
    post_bias = rng.uniform(-3, 3, c_out).astype(np.float32)
    k = 3 * 3 * c_in
    if output_kind == "bitpacked":
        w = w * np.where(post_mul >= 0, 1.0, -1.0)[:, None, None, None]
        thr = compute_output_thresholds(post_mul, post_bias, k)
        t, jt = (OutputTransform(thresholds=thr),
                 JOutputTransform(thresholds=jcompute_output_thresholds(
                     post_mul, post_bias, k)))
    else:
        scale = 0.05 if output_kind == "int8" else None
        t = fuse_output_transform(post_mul, post_bias, k, output_scale=scale)
        jt = jfuse(post_mul, post_bias, k, output_scale=scale)
    params = BConv2DParams(channels_in=c_in, padding=Padding.SAME)
    jparams = JParams(channels_in=c_in, padding=JPadding.SAME)
    port = (bitpack(torch.from_numpy(x)), bitpack(torch.from_numpy(w)), t,
            params)
    jax_ = (jbitpack(jnp.asarray(x)), jbitpack(jnp.asarray(w)), jt, jparams)
    return port, jax_


def _jax_tp(jcase, mesh_shape, output_kind, mode):
    """JAX's ``tp_bconv2d``, jitted (its shard_map runs eagerly many times
    slower), through its XLA lowering: ints and bits do not depend on the
    lowering. Under ``jit`` XLA contracts the epilogue's multiply and add
    into an FMA, which moves an int8 output that lies within a rounding of
    a tie by one step; eagerly (two roundings, as the port) JAX's own test
    holds its ``tp_bconv2d`` equal to its single-device op, so the int8
    case is also held to that op exactly."""
    jxp, jwp, jt, jparams = jcase
    mesh = jmake_mesh(mesh_shape)
    return jax.jit(lambda a, b: jtp_bconv2d(
        a, b, jt, jparams, mesh, axis="model", output_kind=output_kind,
        kernel="mxu", mode=mode))(jxp, jwp)


def _assert_like_jax(got, jwant, output_kind):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    jwant = np.asarray(jwant)
    if output_kind == "float":
        np.testing.assert_allclose(got, jwant, **FLOAT_TOL)
    elif output_kind == "bitpacked":
        np.testing.assert_array_equal(got.view(np.uint32), jwant)
    else:  # int8 against the jitted (FMA) epilogue: one step
        assert np.abs(got.astype(np.int32) - jwant).max() <= 1


# S = 4 on a (2, 4) mesh, S = 8 on (1, 8): 256 channels, 64 or 32 a slot.
TP_MESHES = {4: (2, 4), 8: (1, 8)}


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("output_kind", ["float", "bitpacked"])
@pytest.mark.parametrize("mode", ["gather", "sharded"])
def test_tp_bconv2d_matches_jax(mode, output_kind, shards):
    (xp, wp, t, params), jcase = _tp_case(output_kind, 2)
    mesh_shape = TP_MESHES[shards]
    got = tp_bconv2d(xp, wp, t, params, make_mesh(mesh_shape, devices=CPU8),
                     output_kind=output_kind, mode=mode)
    jgot = _jax_tp(jcase, mesh_shape, output_kind, mode)
    _assert_like_jax(got.join(), jgot, output_kind)
    # and the single-slot op of the port, exactly
    assert torch.equal(got.join(), bconv2d(xp, wp, t, params, output_kind))


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("output_kind", ["float", "int8", "bitpacked"])
def test_tp_bconv2d_pipelined_matches_jax(output_kind, shards):
    """The weight ring, whose order and roll show an off-by-one only from
    three slots on."""
    (xp, wp, t, params), jcase = _tp_case(output_kind, 8)
    mesh_shape = TP_MESHES[shards]
    got = tp_bconv2d(xp, wp, t, params, make_mesh(mesh_shape, devices=CPU8),
                     output_kind=output_kind, mode="pipelined")
    assert got.spec == ("model",)
    jgot = _jax_tp(jcase, mesh_shape, output_kind, "pipelined")
    assert jgot.sharding.spec[0] == "model"
    _assert_like_jax(got.join(), jgot, output_kind)
    if output_kind == "int8":
        jxp, jwp, jt, jparams = jcase
        np.testing.assert_array_equal(got.join().numpy(), np.asarray(
            jbconv2d(jxp, jwp, jt, jparams, "int8", kernel="mxu")))
    assert torch.equal(got.join(), bconv2d(xp, wp, t, params, output_kind))


@pytest.mark.parametrize("output_kind", ["float", "bitpacked"])
def test_tp_bconv2d_sharded_slices_are_channel_slices(output_kind):
    (xp, wp, t, params), _ = _tp_case(output_kind, 2)
    got = tp_bconv2d(xp, wp, t, params, make_mesh((2, 4), devices=CPU8),
                     output_kind=output_kind, mode="sharded")
    want = bconv2d(xp, wp, t, params, output_kind)
    assert got.spec == (None, None, None, "model")
    width = want.shape[-1] // 4
    assert {tuple(s.shape) for s in got.shards} == {
        (*want.shape[:-1], width)}
    for (d, j), _ in got.mesh.slots():
        assert torch.equal(got.shard((d, j)),
                           want[..., j * width:(j + 1) * width])


def test_tp_bconv2d_pipelined_issues_ring_copies_and_no_all_gather():
    """The port's counterpart of JAX's HLO check: the pipelined mode's
    collectives are the ring's copies (S - 1 steps, S copies each, on every
    line of slots), never an all-gather; gather's are all-gathers."""
    (xp, wp, t, params), _ = _tp_case("float", 8)
    mesh = make_mesh((2, 4), devices=CPU8)
    log = []
    tp_bconv2d(xp, wp, t, params, mesh, mode="pipelined", log=log)
    assert {r["kind"] for r in log} == {"ppermute"}
    assert len(log) == 2 * 3 * 4
    # a packed filter shard of 64 channels x 9 x 2 words + two 64-float
    # vectors of the transform
    assert {r["bytes"] for r in log} == {64 * 9 * 2 * 4 + 2 * 64 * 4}
    log = []
    tp_bconv2d(xp, wp, t, params, mesh, mode="gather", log=log)
    assert {r["kind"] for r in log} == {"all_gather"}


def test_tp_bconv2d_rejects_indivisible_channels():
    """``test_error_paths.py``'s case: 30 channels over 8 model slots."""
    (xp, wp, t, params), (jxp, jwp, jt, jparams) = _tp_case("float", 1,
                                                            c_out=32)
    cut = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                          multiplier=t.multiplier[:30], bias=t.bias[:30])
    with pytest.raises(ValueError, match="not divisible"):
        tp_bconv2d(xp, wp[:30], cut, params,
                   make_mesh((1, 8), devices=CPU8), axis="model")
    jcut = JOutputTransform(clamp_min=jt.clamp_min, clamp_max=jt.clamp_max,
                            multiplier=jt.multiplier[:30],
                            bias=jt.bias[:30])
    with pytest.raises(ValueError, match="not divisible"):
        jtp_bconv2d(jxp, jwp[:30], jcut, jparams, jmake_mesh((1, 8)),
                    axis="model")


def test_tp_pipelined_rejects_indivisible_batch():
    """``test_error_paths.py``'s case: a batch of 1 over 4 model slots."""
    (xp, wp, t, params), (jxp, jwp, jt, jparams) = _tp_case("float", 1,
                                                            c_out=32)
    with pytest.raises(ValueError, match="batch"):
        tp_bconv2d(xp, wp, t, params, make_mesh((2, 4), devices=CPU8),
                   axis="model", mode="pipelined")
    with pytest.raises(ValueError, match="batch"):
        jtp_bconv2d(jxp, jwp, jt, jparams, jmake_mesh((2, 4)), axis="model",
                    mode="pipelined")


@pytest.mark.parametrize("mode", ["gather", "pipelined"])
def test_tp_bitpacked_shards_must_be_whole_words(mode):
    """64 channels over 4 slots: 16 a slot, not a whole word."""
    (xp, wp, t, params), (jxp, jwp, jt, jparams) = _tp_case("bitpacked", 4,
                                                            c_out=64)
    with pytest.raises(ValueError, match="multiple of 32"):
        tp_bconv2d(xp, wp, t, params, make_mesh((2, 4), devices=CPU8),
                   output_kind="bitpacked", mode=mode)
    with pytest.raises(ValueError, match="multiple of 32"):
        jtp_bconv2d(jxp, jwp, jt, jparams, jmake_mesh((2, 4)), axis="model",
                    output_kind="bitpacked", mode=mode)
