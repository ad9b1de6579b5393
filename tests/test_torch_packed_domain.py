"""Packed-domain model execution in the port (plain versions, on the CPU)
against the JAX package: binary layers chained through bitpacked
activations, packed pooling and flatten, the float-domain bgemm route, and
the deferred residual conv reused after its fused add."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core import bitpack as jbitpack
from compute_engine_tpu.models import (convert_model as jconvert,
                                       init_model as jinit,
                                       packed_apply as japply,
                                       tiny_quicknet as jtiny_quicknet)
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec

from compute_engine_tpu_torch.core import bitpack
from compute_engine_tpu_torch.interop import layers_from_numpy
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.models.builder import PackedBuilder
from compute_engine_tpu_torch.models.zoo import ModelSpec


def _mini_alexnet(b, x, num_classes=10):
    """BinaryAlexNet's topology at toy scale (tests/test_packed_domain.py):
    conv2 -> pool -> conv3 -> conv4 -> conv5 -> pool -> flatten -> fc1 stay
    bitpacked; fc2 feeds the float head."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv4")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 2, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 128, name="fc1")
    x = b.binary_dense_bn(x, 128, name="fc2")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def _trunk(b, x):
    """Ends on a binary layer: the model returns packed words."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")
    return b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv3")


def _bgemm_route(b, x, num_classes=6):
    """The binary layers that the residual kernel does not take: a
    zero-padded stride-2 conv at an odd depth, a 5x5 conv and a binary
    dense."""
    x = b.conv_bn(x, 33, 3, stride=2, name="stem")
    x = b.binary_conv_bn(x, 40, 3, stride=2, pad_value=0, name="zpad_s2")
    x = b.binary_conv_bn(x, 32, 5, pad_value=1, name="conv5x5")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 24, name="fc")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def _reused_after_add(b, x):
    """A deferred residual conv consumed by its own add and by a concat."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    y = b.binary_conv_bn(x, 32, 3, pad_value=1, name="block")
    x2 = b.add(x, y)
    return b.concat([x2, y])


def _specs(forward, size, num_classes=10):
    return (JModelSpec("m", forward, input_size=(size, size),
                       num_classes=num_classes),
            ModelSpec("m", forward, input_size=(size, size),
                      num_classes=num_classes))


MINI = _specs(_mini_alexnet, 32)


@pytest.fixture(scope="module")
def mini_layers():
    jspec, spec = MINI
    want = jconvert(jspec, jinit(jspec, seed=3, randomize_bn=True))
    got = convert_model(spec, init_model(spec, seed=3, randomize_bn=True))
    for name, entry in want.items():
        for k, v in entry.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[name][k], v)
    return want


def _x(rng, n, size=32):
    return rng.normal(0, 1, (n, size, size, 3)).astype(np.float32)


def _jax(spec, layers, x, dtype=jnp.float32, **kw):
    return np.asarray(japply(spec, layers, jnp.asarray(x),
                             compute_dtype=dtype, **kw), np.float32)


def _port(spec, layers, x, dtype=torch.float32, **kw):
    out = packed_apply(spec, layers, x, compute_dtype=dtype, device="cpu",
                       **kw)
    return out.float().numpy() if out.is_floating_point() else out.numpy()


@pytest.mark.parametrize("domain", ["float", "packed"])
def test_mini_alexnet_matches_jax_float32(mini_layers, rng, domain):
    """JAX's "mxu" kernel keeps its side fast on the CPU; every lowering
    is bit-exact in the binary trunk."""
    jspec, spec = MINI
    x = _x(rng, 4)
    want = _jax(jspec, mini_layers, x, kernel="mxu", return_logits=True,
                domain=domain)
    got = _port(spec, mini_layers, x, return_logits=True, domain=domain)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_mini_alexnet_domains_agree_in_the_port(mini_layers, rng):
    """The binary trunk is bit-exact between domains (thresholds equal the
    sign of the float output), so only the float head could differ."""
    _, spec = MINI
    x = _x(rng, 4)
    a = _port(spec, mini_layers, x, return_logits=True)
    b = _port(spec, mini_layers, x, return_logits=True, domain="packed")
    np.testing.assert_allclose(a, b, atol=1e-3)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_mini_alexnet_bf16_top1_matches_jax(mini_layers, rng):
    jspec, spec = MINI
    x = _x(rng, 8)
    want = _jax(jspec, mini_layers, x, dtype=jnp.bfloat16, kernel="mxu",
                domain="packed")
    got = _port(spec, mini_layers, x, dtype=torch.bfloat16, domain="packed")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_packed_trunk_returns_jax_words(rng):
    jspec, spec = _specs(_trunk, 32, num_classes=0)
    layers = jconvert(jspec, jinit(jspec, seed=0, randomize_bn=True))
    x = _x(rng, 2)
    want = np.asarray(japply(jspec, layers, jnp.asarray(x), kernel="mxu",
                             compute_dtype=jnp.float32, domain="packed"))
    got = _port(spec, layers, x, domain="packed")
    assert got.dtype == np.int32 and got.shape[-1] == 64 // 32
    np.testing.assert_array_equal(got.view(np.uint32), want)
    # The words are the sign of the float-domain output.
    out_f = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                         device="cpu")
    assert torch.equal(bitpack(out_f).view(torch.int32),
                       torch.from_numpy(got))
    np.testing.assert_array_equal(
        want, np.asarray(jbitpack(jnp.asarray(out_f.numpy()))))


def test_tiny_quicknet_packed_domain_matches_jax(rng):
    """Residual adds pull the float view of each binary stream."""
    kw = dict(section_filters=(32, 64), section_blocks=(2, 2), num_classes=8)
    jspec, spec = jtiny_quicknet(**kw), tiny_quicknet(**kw)
    layers = jconvert(jspec, jinit(jspec, seed=1, randomize_bn=True))
    x = _x(rng, 2)
    want = _jax(jspec, layers, x, kernel="mxu", domain="packed")
    got = _port(spec, layers, x, domain="packed")
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, _port(spec, layers, x), atol=1e-3)


def test_artifact_without_thresholds_runs_in_the_float_domain(mini_layers,
                                                              rng):
    _, spec = MINI
    stripped = {name: {k: v for k, v in layer.items()
                       if k not in ("thresholds", "packed_filter_flipped",
                                    "packed_kernel_flipped")}
                for name, layer in mini_layers.items()}
    x = _x(rng, 2)
    got = _port(spec, stripped, x, domain="packed")
    want = _port(spec, mini_layers, x)
    np.testing.assert_array_equal(got, want)


def test_float_domain_bgemm_route_matches_jax(rng):
    jspec, spec = _specs(_bgemm_route, 16, num_classes=6)
    layers = jconvert(jspec, jinit(jspec, seed=2, randomize_bn=True))
    x = _x(rng, 2, 16)
    want = _jax(jspec, layers, x, kernel="bgemm")
    got = _port(spec, layers, x)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_binary_layers_route_through_bgemm(rng):
    """In the packed domain every binary layer of the mini AlexNet is one
    bgemm call: five bitpacked, and fc2's float output for the head."""
    _, spec = MINI
    layers = convert_model(spec, init_model(spec, seed=3, randomize_bn=True))
    calls = []

    def gemm(lhs, rhs, *a, out_kind, **kw):
        from compute_engine_tpu_torch.kernels.bgemm import bgemm_plain

        calls.append(out_kind)
        return bgemm_plain(lhs, rhs, *a, out_kind=out_kind, **kw)

    packed_apply(spec, layers, _x(rng, 1), device="cpu", domain="packed",
                 gemm=gemm)
    assert calls == ["bitpacked"] * 5 + ["float"]


def test_deferred_conv_after_fused_add_is_fused_minus_x(rng):
    """A conv consumed by its residual add and by another layer: the second
    consumer gets ``fused - x``, as in JAX, not a second conv."""
    jspec, spec = _specs(_reused_after_add, 16, num_classes=0)
    layers = jconvert(jspec, jinit(jspec, seed=4, randomize_bn=True))
    x = _x(rng, 2, 16)
    want = _jax(jspec, layers, x, kernel="residual")
    calls = []

    def block(*a, has_residual=True, **kw):
        from compute_engine_tpu_torch.kernels.residual import (
            binary_residual_block_plain)

        calls.append(has_residual)
        return binary_residual_block_plain(*a, has_residual=has_residual,
                                           **kw)

    got = _port(spec, layers, x, residual_block=block)
    assert calls == [True]
    # tests/test_torch_residual.py's tolerance for the fused block.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_layers_from_numpy_carries_packed_domain_arrays(mini_layers):
    runtime = layers_from_numpy(mini_layers)
    for name, kind, words in (("conv3", "bconv", "packed_filter_flipped"),
                              ("fc1", "bdense", "packed_kernel_flipped"),
                              ("fc1", "bdense", "packed_kernel")):
        a = mini_layers[name]
        assert a["kind"] == kind
        t = runtime[name][words]
        assert t.dtype == torch.int32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy().view(np.uint32), a[words])
        thr = runtime[name]["thresholds"]
        assert thr.dtype == torch.int32
        np.testing.assert_array_equal(thr.numpy(), a["thresholds"])


def test_unknown_domain_raises(mini_layers):
    with pytest.raises(ValueError, match="domain"):
        PackedBuilder(mini_layers, domain="bits")
