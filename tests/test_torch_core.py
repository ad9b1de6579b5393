"""The PyTorch port's core against the JAX package: bit layout, transform
math, padding arithmetic. Inputs come from numpy; the port runs on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core import bitpack as jbitpack
from compute_engine_tpu.core import bitunpack as jbitunpack
from compute_engine_tpu.core.bitpack import bitpack_np as jbitpack_np
from compute_engine_tpu.core.params import BConv2DParams as JParams
from compute_engine_tpu.core.transforms import (
    apply_output_transform_float as japply_float,
    apply_output_transform_int8 as japply_int8,
    compute_output_thresholds as jthresholds,
    fuse_output_transform as jfuse,
)
from compute_engine_tpu.core.types import Activation as JActivation
from compute_engine_tpu.core.types import Padding as JPadding
from compute_engine_tpu.core.types import round_half_away as jround

from compute_engine_tpu_torch.core import (
    Activation,
    BConv2DParams,
    Padding,
    bitpack,
    bitpack_np,
    bitunpack,
    compute_output_thresholds,
    fuse_output_transform,
    round_half_away,
    saturate_int8,
)
from compute_engine_tpu_torch.core.transforms import (
    apply_output_transform_float,
    apply_output_transform_int8,
)

CHANNELS = [1, 31, 32, 33, 64, 65]


def _words(t):
    """Port int32 words as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


def _float_input(rng, c):
    x = rng.normal(0, 1, (3, 5, c)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[3::11] = -0.0  # -0.0 packs as +1 (bit 0)
    return x


@pytest.mark.parametrize("c", CHANNELS)
def test_bitpack_float_matches_jax(rng, c):
    x = _float_input(rng, c)
    want = np.asarray(jbitpack(jnp.asarray(x)))
    np.testing.assert_array_equal(_words(bitpack(torch.from_numpy(x))), want)
    np.testing.assert_array_equal(bitpack_np(x), want)
    assert bitpack_np(x).dtype == np.uint32
    np.testing.assert_array_equal(bitpack_np(x), jbitpack_np(x))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("zero_point", [-128, -5, 0, 3, 127, 200])
def test_bitpack_int8_matches_jax(rng, c, zero_point):
    x = rng.integers(-128, 128, size=(4, c), dtype=np.int8)
    want = np.asarray(jbitpack(jnp.asarray(x), zero_point=zero_point))
    np.testing.assert_array_equal(
        _words(bitpack(torch.from_numpy(x), zero_point=zero_point)), want)
    np.testing.assert_array_equal(bitpack_np(x, zero_point=zero_point), want)


@pytest.mark.parametrize("c", CHANNELS)
def test_bitpack_bool_matches_jax(rng, c):
    b = rng.integers(0, 2, size=(3, c)).astype(bool)
    want = np.asarray(jbitpack(jnp.asarray(b)))
    np.testing.assert_array_equal(_words(bitpack(torch.from_numpy(b))), want)
    np.testing.assert_array_equal(bitpack_np(b), want)


@pytest.mark.parametrize("c", CHANNELS)
def test_bitunpack_matches_jax(rng, c):
    words = jbitpack(jnp.asarray(_float_input(rng, c)))
    tw = torch.from_numpy(np.array(words).view(np.int32))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.int8, torch.int8),
                     (jnp.bool_, torch.bool)):
        want = np.asarray(jbitunpack(words, c, dtype=jdt))
        got = bitunpack(tw, c, dtype=tdt).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jbitunpack(words, c, zero_bit_result=7,
                                 one_bit_result=-3, dtype=jnp.int8))
    got = bitunpack(tw, c, zero_bit_result=7, one_bit_result=-3,
                    dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got, want)


def test_bitunpack_rejects_wrong_depth():
    with pytest.raises(ValueError, match="does not match"):
        bitunpack(torch.zeros((2, 2), dtype=torch.int32), 65)


@pytest.mark.parametrize("activation", list(Activation))
@pytest.mark.parametrize("int8_out", [False, True])
def test_fuse_output_transform_matches_jax(rng, activation, int8_out):
    mul = rng.uniform(-2, 2, 40).astype(np.float32)
    bias = rng.normal(0, 3, 40).astype(np.float32)
    kw = dict(output_scale=0.05, output_zero_point=-3) if int8_out else {}
    want = jfuse(mul, bias, 288, JActivation[activation.name], **kw)
    got = fuse_output_transform(mul, bias, 288, activation, **kw)
    assert (got.clamp_min, got.clamp_max) == (want.clamp_min, want.clamp_max)
    np.testing.assert_array_equal(got.multiplier, want.multiplier)
    np.testing.assert_array_equal(got.bias, want.bias)


@pytest.mark.parametrize("activation", list(Activation))
def test_compute_output_thresholds_matches_jax(rng, activation):
    mul = rng.uniform(-2, 2, 64).astype(np.float32)
    mul[:3] = 0.0  # the +-inf branches
    mul[3] = 1e-3  # range that does not cross 0
    bias = rng.normal(0, 20, 64).astype(np.float32)
    bias[0] = -1.0
    want = jthresholds(mul, bias, 576, JActivation[activation.name])
    got = compute_output_thresholds(mul, bias, 576, activation)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


SPATIAL = [
    (224, 224, 3, 3, (2, 2), (1, 1), "SAME"),
    (56, 56, 3, 3, (1, 1), (1, 1), "SAME"),
    (7, 9, 3, 3, (2, 2), (1, 1), "VALID"),
    (16, 15, 5, 3, (1, 2), (2, 1), "SAME"),
    (33, 32, 1, 5, (3, 1), (1, 2), "VALID"),
]


@pytest.mark.parametrize("h,w,fh,fw,stride,dilation,padding", SPATIAL)
def test_output_spatial_matches_jax(h, w, fh, fw, stride, dilation, padding):
    jp = JParams(channels_in=64, stride=stride, dilation=dilation,
                 padding=JPadding[padding])
    tp = BConv2DParams(channels_in=64, stride=stride, dilation=dilation,
                       padding=Padding[padding])
    assert tp.output_spatial(h, w, fh, fw) == jp.output_spatial(h, w, fh, fw)
    assert tp.backtransform_add(fh, fw) == jp.backtransform_add(fh, fw)


def test_rounding_and_saturation_match_jax():
    y = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.6, -130.2, 0.49],
                 np.float32)
    want = np.asarray(jround(jnp.asarray(y)))
    np.testing.assert_array_equal(round_half_away(torch.from_numpy(y)).numpy(),
                                  want)
    q = saturate_int8(torch.tensor([-300, -128, 0, 127, 300]))
    assert q.dtype == torch.int8
    assert q.tolist() == [-128, -128, 0, 127, 127]


@pytest.mark.parametrize("activation", [Activation.NONE, Activation.RELU6])
def test_apply_output_transform_matches_jax(rng, activation):
    accum = rng.integers(0, 577, size=(2, 3, 48)).astype(np.int32)
    tr = fuse_output_transform(rng.uniform(-0.1, 0.1, 48),
                               rng.normal(0, 5, 48), 576, activation)
    np.testing.assert_array_equal(
        apply_output_transform_float(torch.from_numpy(accum), tr).numpy(),
        np.asarray(japply_float(jnp.asarray(accum), tr)))
    np.testing.assert_array_equal(
        apply_output_transform_int8(torch.from_numpy(accum), tr).numpy(),
        np.asarray(japply_int8(jnp.asarray(accum), tr)))
