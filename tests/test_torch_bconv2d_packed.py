"""Packed-domain ops of the port (plain versions, on the CPU) against the JAX
package: the packed im2col and zero-padding correction, the reference conv,
``bconv2d`` through the binary GEMM, ``quantize``/``dequantize`` and
``bmaxpool2d``, on the cases of tests/test_reference_bconv.py and
tests/test_fast_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core import (
    Activation as JActivation,
    BConv2DParams as JParams,
    Padding as JPadding,
    bconv2d_reference as jbconv2d_reference,
    compute_output_thresholds,
    fuse_output_transform,
    OutputTransform as JTransform,
)
from compute_engine_tpu.core.reference import (
    extract_packed_patches as jextract,
    outside_tap_mask as joutside_tap_mask,
    zero_padding_accum_correction as jcorrection,
)
from compute_engine_tpu.ops import (bmaxpool2d as jbmaxpool2d,
                                    dequantize as jdequantize,
                                    quantize as jquantize)

from compute_engine_tpu_torch.core import (Activation, BConv2DParams,
                                           OutputTransform, Padding,
                                           bitpack_np)
from compute_engine_tpu_torch.core.reference import (
    bconv2d_reference,
    extract_packed_patches,
    outside_tap_mask,
    zero_padding_accum_correction,
)
from compute_engine_tpu_torch.ops import (bconv2d, bmaxpool2d, dequantize,
                                          quantize)

# (in_shape, filter (O, FH, FW), stride, dilation, padding, pad_value,
#  groups, activation): tests/test_reference_bconv.py's cases (which hold
#  tests/test_fast_kernels.py's), and zero padding at an odd depth.
CASES = [
    ((1, 8, 8, 32), (16, 3, 3), (1, 1), (1, 1), "VALID", 1, 1, "NONE"),
    ((2, 7, 9, 64), (8, 3, 3), (1, 1), (1, 1), "SAME", 1, 1, "NONE"),
    ((1, 8, 8, 64), (32, 3, 3), (2, 2), (1, 1), "SAME", 1, 1, "RELU"),
    ((1, 10, 10, 33), (7, 2, 2), (1, 1), (2, 2), "VALID", 1, 1, "NONE"),
    ((1, 8, 8, 64), (16, 3, 3), (1, 1), (1, 1), "SAME", 0, 1, "NONE"),
    ((1, 9, 9, 64), (12, 3, 3), (2, 2), (1, 1), "SAME", 0, 1, "NONE"),
    ((1, 6, 6, 64), (8, 3, 3), (1, 1), (1, 1), "VALID", 1, 2, "NONE"),
    ((1, 6, 6, 128), (16, 3, 3), (1, 1), (1, 1), "SAME", 1, 4, "RELU6"),
    ((1, 5, 5, 1), (4, 1, 1), (1, 1), (1, 1), "VALID", 1, 1, "NONE"),
    ((1, 4, 4, 300), (40, 2, 2), (1, 1), (1, 1), "SAME", 1, 1,
     "RELU_N1_TO_1"),
    ((2, 9, 9, 33), (16, 3, 3), (2, 2), (1, 1), "SAME", 0, 1, "NONE"),
]


def _t(words):
    return torch.from_numpy(np.array(words).view(np.int32))


def _np(t):
    """Port output as numpy, packed words viewed as uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _params(case):
    in_shape, _, stride, dilation, padding, pad_value, groups, act = case
    kw = dict(channels_in=in_shape[-1], stride=stride, dilation=dilation,
              pad_value=pad_value, groups=groups)
    return (JParams(padding=JPadding[padding], activation=JActivation[act],
                    **kw),
            BConv2DParams(padding=Padding[padding],
                          activation=Activation[act], **kw))


def _case(rng, case, output_kind):
    """Packed input and filter (uint32) and the transform of one case."""
    in_shape, (o, fh, fw), *_ = case
    jp, tp = _params(case)
    c = in_shape[-1]
    x = rng.choice(np.array([-1.0, 1.0], np.float32), size=in_shape)
    w = rng.choice(np.array([-1.0, 1.0], np.float32),
                   size=(o, fh, fw, c // jp.groups))
    post_mul = (rng.uniform(0.1, 2.0, o)
                * rng.choice([-1.0, 1.0], o)).astype(np.float32)
    post_bias = rng.uniform(-5.0, 5.0, o).astype(np.float32)
    k = jp.backtransform_add(fh, fw)
    if output_kind == "bitpacked":
        # Thresholds assume the filter pre-multiplied by sign(mul).
        w = w * np.where(post_mul >= 0, 1.0, -1.0)[:, None, None, None]
        thr = compute_output_thresholds(post_mul, post_bias, k,
                                        jp.activation)
        jt, tt = JTransform(thresholds=thr), OutputTransform(thresholds=thr)
    else:
        scale, zp = (0.15, 3) if output_kind == "int8" else (None, 0)
        jt = fuse_output_transform(post_mul, post_bias, k, jp.activation,
                                   output_scale=scale, output_zero_point=zp)
        tt = OutputTransform(clamp_min=jt.clamp_min, clamp_max=jt.clamp_max,
                             multiplier=jt.multiplier, bias=jt.bias)
    # bitpack_np equals JAX's bitpack (tests/test_torch_core.py).
    return jp, tp, bitpack_np(x), bitpack_np(w), jt, tt


def _assert_matches(got, want, output_kind):
    assert got.shape == want.shape and got.dtype == want.dtype
    if output_kind == "float":
        # One FMA rounding: JAX's compiler may contract mul + bias.
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("output_kind", ["float", "int8", "bitpacked"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_bconv2d_bgemm_matches_jax_reference(rng, case, output_kind):
    jp, tp, xp, wp, jt, tt = _case(rng, case, output_kind)
    want = np.asarray(jbconv2d_reference(jnp.asarray(xp), jnp.asarray(wp),
                                         jt, jp, output_kind))
    got = _np(bconv2d(_t(xp), _t(wp), tt, tp, output_kind, kernel="bgemm"))
    _assert_matches(got, want, output_kind)
    # "auto" is "bgemm" until the port has a kernel table.
    auto = _np(bconv2d(_t(xp), _t(wp), tt, tp, output_kind))
    np.testing.assert_array_equal(auto, got)


@pytest.mark.parametrize("output_kind", ["float", "int8", "bitpacked"])
@pytest.mark.parametrize("case", CASES[1:7:2], ids=[1, 3, 5])
def test_reference_matches_jax_reference(rng, case, output_kind):
    jp, tp, xp, wp, jt, tt = _case(rng, case, output_kind)
    want = np.asarray(jbconv2d_reference(jnp.asarray(xp), jnp.asarray(wp),
                                         jt, jp, output_kind))
    got = _np(bconv2d(_t(xp), _t(wp), tt, tp, output_kind,
                      kernel="reference"))
    _assert_matches(got, want, output_kind)
    assert torch.equal(
        bconv2d_reference(_t(xp), _t(wp), tt, tp, output_kind),
        bconv2d(_t(xp), _t(wp), tt, tp, output_kind, kernel="reference"))


@pytest.mark.parametrize("case", [c for c in CASES if c[4] == "SAME"],
                         ids=lambda c: f"{c[0][1]}x{c[0][2]}s{c[2][0]}")
def test_patches_and_zero_padding_correction_match_jax(rng, case):
    in_shape, (o, fh, fw), stride, dilation, *_ = case
    jp, tp = _params(case)
    in_h, in_w = in_shape[1:3]
    out_h, out_w, pt, pl = jp.output_spatial(in_h, in_w, fh, fw)
    xp = rng.integers(0, 2 ** 32, size=(*in_shape[:3], -(-in_shape[3] // 32)),
                      dtype=np.uint32)
    wp = rng.integers(0, 2 ** 32, size=(o, fh, fw,
                                        -(-jp.channels_in_per_group // 32)),
                      dtype=np.uint32)
    want = np.asarray(jextract(jnp.asarray(xp), fh, fw, stride, dilation, pt,
                               pl, out_h, out_w))
    got = _np(extract_packed_patches(_t(xp), fh, fw, stride, dilation, pt,
                                     pl, out_h, out_w))
    np.testing.assert_array_equal(got, want)
    mask = outside_tap_mask(in_h, in_w, out_h, out_w, fh, fw, stride,
                            dilation, pt, pl)
    np.testing.assert_array_equal(
        mask, joutside_tap_mask(in_h, in_w, out_h, out_w, fh, fw, stride,
                                dilation, pt, pl))
    np.testing.assert_array_equal(
        zero_padding_accum_correction(_t(wp), tp, mask).numpy(),
        np.asarray(jcorrection(jnp.asarray(wp), jp, mask)))


def test_bconv2d_checks_match_jax():
    _, tp = _params(CASES[6])  # groups 2, 64 channels
    x = torch.zeros((1, 6, 6, 2), dtype=torch.int32)
    f = torch.zeros((8, 3, 3, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="packed_input"):
        bconv2d(x.float(), f, OutputTransform(), tp)
    with pytest.raises(ValueError, match="packed filter depth"):
        bconv2d(x, torch.zeros((8, 3, 3, 2), dtype=torch.int32),
                OutputTransform(), tp)
    with pytest.raises(ValueError, match="packed input depth"):
        bconv2d(x[..., :1], f, OutputTransform(), tp)
    with pytest.raises(ValueError, match="multiple of 32"):
        bconv2d(torch.zeros((1, 6, 6, 2), dtype=torch.int32),
                torch.zeros((8, 3, 3, 1), dtype=torch.int32),
                OutputTransform(),
                BConv2DParams(channels_in=40, groups=2))
    with pytest.raises(ValueError, match="output_kind"):
        bconv2d(x, f, OutputTransform(), tp, output_kind="bits8")
    with pytest.raises(ValueError, match="unknown kernel"):
        bconv2d(x, f, OutputTransform(), tp, kernel="winograd")


@pytest.mark.parametrize("dtype", ["float32", "int8", "bool"])
@pytest.mark.parametrize("channels", [1, 33, 64])
def test_quantize_dequantize_match_jax(rng, dtype, channels):
    shape = (2, 3, channels)
    if dtype == "float32":
        x = rng.normal(0, 1, shape).astype(np.float32)
        x.reshape(-1)[::7] = 0.0
        zp, kw = 0, {}
    elif dtype == "int8":
        x = rng.integers(-128, 128, shape).astype(np.int8)
        zp, kw = 3, dict(scale=0.25, zero_point=3)
    else:
        x = rng.integers(0, 2, shape).astype(np.bool_)
        zp, kw = 0, {}
    want = np.asarray(jquantize(jnp.asarray(x), zero_point=zp))
    got = quantize(torch.from_numpy(x), zero_point=zp)
    np.testing.assert_array_equal(_np(got), want)
    jdtype = getattr(jnp, "bool_" if dtype == "bool" else dtype)
    tdtype = getattr(torch, dtype)
    np.testing.assert_array_equal(
        dequantize(got, channels, dtype=tdtype, **kw).numpy(),
        np.asarray(jdequantize(jnp.asarray(want), channels, dtype=jdtype,
                               **kw)))


def test_dequantize_int8_needs_a_scale():
    with pytest.raises(ValueError, match="scale"):
        dequantize(torch.zeros((1, 1), dtype=torch.int32), 8,
                   dtype=torch.int8)


@pytest.mark.parametrize("shape,filter_size,stride,padding", [
    ((1, 8, 8, 32), (2, 2), (2, 2), "VALID"),
    ((2, 7, 9, 64), (2, 2), (2, 2), "SAME"),
    ((1, 8, 8, 33), (3, 3), (2, 2), "SAME"),
    ((1, 10, 6, 100), (3, 2), (1, 2), "SAME"),
    ((1, 5, 5, 1), (5, 5), (1, 1), "VALID"),
    ((2, 13, 13, 256), (3, 3), (2, 2), "VALID"),  # BinaryAlexNet's pools
])
def test_bmaxpool_matches_jax(rng, shape, filter_size, stride, padding):
    words = rng.integers(0, 2 ** 32, size=(*shape[:3], -(-shape[3] // 32)),
                         dtype=np.uint32)
    want = np.asarray(jbmaxpool2d(jnp.asarray(words), filter_size, stride,
                                  JPadding[padding]))
    got = bmaxpool2d(_t(words), filter_size, stride, Padding[padding])
    assert got.is_contiguous()
    np.testing.assert_array_equal(_np(got), want)


def test_bmaxpool_rejects_unpacked_input():
    with pytest.raises(TypeError, match="bitpacked"):
        bmaxpool2d(torch.zeros((1, 4, 4, 1)), 2)
