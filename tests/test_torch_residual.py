"""The port's residual block and float-in binary conv (plain versions, on
the CPU) against the JAX package, on the cases of tests/test_residual.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core.params import BConv2DParams as JParams
from compute_engine_tpu.core.transforms import fuse_output_transform
from compute_engine_tpu.core.types import Padding as JPadding
from compute_engine_tpu.kernels.bconv2d import (
    bconv2d_mxu_float_in as jbconv_float_in,
)
from compute_engine_tpu.kernels.residual import (
    binary_residual_block as jblock,
)

from compute_engine_tpu_torch.core import BConv2DParams, Padding, bitpack_np
from compute_engine_tpu_torch.kernels.bconv2d import bconv2d_mxu_float_in
from compute_engine_tpu_torch.kernels.residual import (
    binary_residual_block,
    binary_residual_block_plain,
    residual_block_supported,
)

CASES = [
    (2, 8, 8, 64),
    (1, 6, 6, 128),
    (8, 4, 4, 64),
    (4, 5, 5, 32),
]


def _case(rng, n, h, w, c, identity=False):
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0
    x.reshape(-1)[5::17] = -0.0
    filt = rng.choice([-1.0, 1.0], size=(c, 3, 3, c)).astype(np.float32)
    if identity:
        post_mul, post_bias = np.ones(c, np.float32), np.zeros(c, np.float32)
    else:
        post_mul = rng.uniform(0.1, 2.0, c).astype(np.float32)
        post_bias = rng.uniform(-5, 5, c).astype(np.float32)
    tr = fuse_output_transform(post_mul, post_bias, 9 * c)
    return x, bitpack_np(filt), tr


def _params(c, stride=(1, 1), padding="SAME", pad_value=1, groups=1,
            dilation=(1, 1)):
    kw = dict(channels_in=c, stride=stride, pad_value=pad_value,
              groups=groups, dilation=dilation)
    return (JParams(padding=JPadding[padding], **kw),
            BConv2DParams(padding=Padding[padding], **kw))


def _t(words):
    return torch.from_numpy(np.array(words).view(np.int32))


@pytest.mark.parametrize("n,h,w,c", CASES)
def test_block_bit_exact_identity(rng, n, h, w, c):
    """Identity transform isolates the integer conv and the padding."""
    x, pf, tr = _case(rng, n, h, w, c, identity=True)
    jp, tp = _params(c)
    want = np.asarray(jblock(jnp.asarray(x), jnp.asarray(pf), tr, jp,
                             interpret=True))
    got = binary_residual_block(torch.from_numpy(x), _t(pf), tr, tp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,h,w,c", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_jax(rng, n, h, w, c, dtype):
    """Random transform: equal to within one FMA rounding of the epilogue,
    which JAX's compiler may contract and the port never does."""
    x, pf, tr = _case(rng, n, h, w, c)
    jp, tp = _params(c)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jblock(xj, jnp.asarray(pf), tr, jp, interpret=True),
                      np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got_t = binary_residual_block(xt, _t(pf), tr, tp)
    assert got_t.dtype == xt.dtype
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    else:
        # One bf16 ulp, on under 2% of the elements.
        np.testing.assert_allclose(got, want, rtol=1.6e-2, atol=0.5)
        assert np.mean(got != want) < 0.02


@pytest.mark.parametrize("n,h,w,c", CASES[:2])
def test_block_without_residual_matches_jax_conv(rng, n, h, w, c):
    x, pf, tr = _case(rng, n, h, w, c)
    jp, tp = _params(c)
    want = np.asarray(jbconv_float_in(jnp.asarray(x), jnp.asarray(pf), tr, jp,
                                      conv_dtype=jnp.int8))
    got = binary_residual_block(torch.from_numpy(x), _t(pf), tr, tp,
                                has_residual=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_plain_block_uses_unpacked_filter_identically(rng):
    x, pf, tr = _case(rng, 2, 5, 5, 48)
    _, tp = _params(48)
    upf = torch.from_numpy(rng.choice([-1, 1], size=(3, 3, 48, 48)).astype(
        np.int8))
    pf = _t(bitpack_np(upf.permute(3, 0, 1, 2).numpy()))
    a = binary_residual_block_plain(torch.from_numpy(x), pf, tr, tp)
    b = binary_residual_block_plain(torch.from_numpy(x), pf, tr, tp,
                                    unpacked_filter=upf)
    assert torch.equal(a, b)


# (n, h, w, c_in, c_out, fh, fw, stride, padding, pad_value, groups, dil)
CONVS = [
    (2, 9, 9, 64, 32, 3, 3, (1, 1), "SAME", 1, 1, (1, 1)),    # one-pad
    (2, 9, 9, 64, 32, 3, 3, (2, 2), "SAME", 1, 1, (1, 1)),    # stride 2
    (2, 8, 7, 40, 24, 3, 3, (1, 1), "VALID", 1, 1, (1, 1)),   # VALID
    (2, 9, 8, 64, 32, 3, 3, (2, 2), "VALID", 1, 1, (1, 1)),   # s2 VALID
    (2, 8, 8, 64, 32, 3, 3, (1, 1), "SAME", 0, 1, (1, 1)),    # zero-pad
    (2, 9, 9, 33, 16, 3, 3, (2, 2), "SAME", 0, 1, (1, 1)),    # odd depth
    (1, 7, 7, 64, 32, 3, 1, (1, 1), "SAME", 1, 2, (1, 1)),    # groups
    (1, 9, 9, 32, 32, 3, 3, (1, 1), "SAME", 1, 1, (2, 2)),    # dilation
]


@pytest.mark.parametrize("case", CONVS)
@pytest.mark.parametrize("output_kind", ["float", "int8"])
def test_bconv2d_float_in_matches_jax(rng, case, output_kind):
    n, h, w, ci, co, fh, fw, stride, padding, pad_value, groups, dil = case
    cg = ci // groups
    x = rng.normal(0, 1, (n, h, w, ci)).astype(np.float32)
    x.reshape(-1)[::9] = 0.0
    pf = bitpack_np(rng.choice([-1.0, 1.0], size=(co, fh, fw, cg)))
    tr = fuse_output_transform(rng.uniform(-1.5, 1.5, co) / fh / fw / cg,
                               rng.normal(0, 2, co), fh * fw * cg)
    jp, tp = _params(ci, stride, padding, pad_value, groups, dil)
    want = np.asarray(jbconv_float_in(jnp.asarray(x), jnp.asarray(pf), tr, jp,
                                      output_kind=output_kind,
                                      conv_dtype=jnp.int8))
    got = bconv2d_mxu_float_in(torch.from_numpy(x), _t(pf), tr, tp,
                               output_kind=output_kind).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if output_kind == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_bconv2d_float_in_rejects_channel_mismatch(rng):
    _, tp = _params(32)
    with pytest.raises(ValueError, match="channels_in"):
        bconv2d_mxu_float_in(torch.zeros(1, 4, 4, 64), torch.zeros(
            8, 3, 3, 2, dtype=torch.int32), None, tp)


def test_supported_predicate():
    _, p = _params(64)
    assert residual_block_supported((2, 8, 8, 64), p, 64, 3, 3)
    assert not residual_block_supported((2, 8, 8, 64), p, 128, 3, 3)
    assert residual_block_supported((2, 8, 8, 64), p, 128, 3, 3,
                                    has_residual=False)
    assert not residual_block_supported((2, 8, 8, 64), p, 64, 5, 5)
    for bad in (_params(64, pad_value=0)[1], _params(64, stride=(2, 2))[1],
                _params(64, groups=2)[1], _params(64, dilation=(2, 2))[1],
                _params(64, padding="VALID")[1]):
        assert not residual_block_supported((2, 8, 8, 64), bad, 64, 3, 3)
    # No TPU VMEM budget: a large tile is supported.
    assert residual_block_supported((1, 512, 512, 256), _params(256)[1], 256,
                                    3, 3)


def test_unsupported_raises(rng):
    x, pf, tr = _case(rng, 2, 8, 8, 64)
    _, bad = _params(64, stride=(2, 2))
    with pytest.raises(ValueError, match="fused residual block unsupported"):
        binary_residual_block(torch.from_numpy(x), _t(pf), tr, bad)
