"""The port's residual block and float-in binary conv (plain versions, on
the CPU) against the JAX package, on the cases of tests/test_residual.py.
JAX's block kernel takes one padding only: a zero-padded block is held to
JAX's zero-padded float-in conv, rounded to the activation type, plus the
add, and to the port's packed oracle (``core.reference``)."""

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

from compute_engine_tpu_torch.core import (BConv2DParams, Padding, bitpack,
                                           bitpack_np, bconv2d_reference)
from compute_engine_tpu_torch.core.reference import (
    outside_tap_mask, zero_padding_accum_correction, zero_padding_tap_delta)
from compute_engine_tpu_torch.kernels.bconv2d import bconv2d_mxu_float_in
from compute_engine_tpu_torch.kernels.residual import (
    binary_residual_block,
    binary_residual_block_plain,
    plan_residual_block,
    residual_block_supported,
)
from compute_engine_tpu_torch.kernels.select import residual_applies
from compute_engine_tpu_torch.models import prepare_runtime_arrays

CASES = [
    (2, 8, 8, 64),
    (1, 6, 6, 128),
    (8, 4, 4, 64),
    (4, 5, 5, 32),
]


def _case(rng, n, h, w, c, identity=False, c_out=None):
    co = c if c_out is None else c_out
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0
    x.reshape(-1)[5::17] = -0.0
    filt = rng.choice([-1.0, 1.0], size=(co, 3, 3, c)).astype(np.float32)
    if identity:
        post_mul, post_bias = np.ones(co, np.float32), np.zeros(co, np.float32)
    else:
        post_mul = rng.uniform(0.1, 2.0, co).astype(np.float32)
        post_bias = rng.uniform(-5, 5, co).astype(np.float32)
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


def _jax_block(x, pf, tr, jp):
    """JAX's block: its kernel under one padding; under zero padding, which
    that kernel refuses, its float-in conv rounded to ``x``'s type plus
    ``x``, the unfused chain the port's block equals."""
    if jp.pad_value == 1:
        return jblock(x, jnp.asarray(pf), tr, jp, interpret=True)
    y = jbconv_float_in(x.astype(jnp.float32), jnp.asarray(pf), tr, jp,
                        conv_dtype=jnp.int8)
    return x + y.astype(x.dtype)


@pytest.mark.parametrize("pad_value", [1, 0])
@pytest.mark.parametrize("n,h,w,c", CASES)
def test_block_bit_exact_identity(rng, n, h, w, c, pad_value):
    """Identity transform isolates the integer conv and the padding."""
    x, pf, tr = _case(rng, n, h, w, c, identity=True)
    jp, tp = _params(c, pad_value=pad_value)
    want = np.asarray(_jax_block(jnp.asarray(x), pf, tr, jp))
    got = binary_residual_block(torch.from_numpy(x), _t(pf), tr, tp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pad_value", [1, 0])
@pytest.mark.parametrize("n,h,w,c", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_jax(rng, n, h, w, c, dtype, pad_value):
    """Random transform: equal to within one FMA rounding of the epilogue,
    which JAX's compiler may contract and the port never does."""
    x, pf, tr = _case(rng, n, h, w, c)
    jp, tp = _params(c, pad_value=pad_value)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(_jax_block(xj, pf, tr, jp), np.float32)
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


@pytest.mark.parametrize("pad_value", [1, 0])
@pytest.mark.parametrize("n,h,w,c", CASES[:2])
def test_block_without_residual_matches_jax_conv(rng, n, h, w, c, pad_value):
    x, pf, tr = _case(rng, n, h, w, c)
    jp, tp = _params(c, pad_value=pad_value)
    want = np.asarray(jbconv_float_in(jnp.asarray(x), jnp.asarray(pf), tr, jp,
                                      conv_dtype=jnp.int8))
    got = binary_residual_block(torch.from_numpy(x), _t(pf), tr, tp,
                                has_residual=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("pad_value", [1, 0])
def test_plain_block_uses_unpacked_filter_identically(rng, pad_value):
    x, pf, tr = _case(rng, 2, 5, 5, 48)
    _, tp = _params(48, pad_value=pad_value)
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


@pytest.mark.parametrize("pad_value", [1, 0])
def test_supported_predicate(pad_value):
    _, p = _params(64, pad_value=pad_value)
    assert residual_block_supported((2, 8, 8, 64), p, 64, 3, 3)
    assert not residual_block_supported((2, 8, 8, 64), p, 128, 3, 3)
    assert residual_block_supported((2, 8, 8, 64), p, 128, 3, 3,
                                    has_residual=False)
    assert not residual_block_supported((2, 8, 8, 64), p, 64, 5, 5)
    for bad in (_params(64, stride=(2, 2), pad_value=pad_value)[1],
                _params(64, groups=2, pad_value=pad_value)[1],
                _params(64, dilation=(2, 2), pad_value=pad_value)[1],
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


# -- zero padding ------------------------------------------------------------

# (n, h, w, c, c_out): images whose borders are most of them, and C != C_out
# without the add.
ZERO_PAD_CASES = [(2, h, w, c, None) for h, w in ((1, 1), (2, 3), (3, 2),
                                                  (7, 7))
                  for c in (32, 64, 96)]
ZERO_PAD_CASES += [(3, 3, 7, 33, None), (2, 5, 4, 20, None),
                   (2, 3, 3, 64, 32), (1, 7, 2, 96, 160)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,c_out", ZERO_PAD_CASES)
def test_zero_padded_block_matches_packed_oracle(rng, n, h, w, c, c_out,
                                                 dtype):
    """The zero-padded block is the packed oracle's conv (its zero-padding
    correction included), rounded to the activation type, plus the add:
    equal bit for bit, odd depths included (the kernel refuses none)."""
    x, pf, tr = _case(rng, n, h, w, c, c_out=c_out)
    _, tp = _params(c, pad_value=0)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = bconv2d_reference(bitpack(xt), _t(pf), tr, tp).to(xt.dtype)
    residual = c_out is None
    want = xt + y if residual else y
    got = binary_residual_block(xt, _t(pf), tr, tp, has_residual=residual)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 4), (3, 2), (5, 6)])
@pytest.mark.parametrize("c", [32, 33, 96])
def test_tap_delta_sums_to_the_correction(rng, h, w, c):
    """The (O, 9) table that the kernel adds from, summed over the taps that
    fall outside at each position (its tap pattern), is the oracle's
    zero-padding correction there; ``prepare_runtime_arrays`` holds it for a
    zero-padded conv and for no other."""
    _, pf, _ = _case(rng, 1, h, w, c, c_out=40)
    _, tp = _params(c, pad_value=0)
    delta = zero_padding_tap_delta(_t(pf), tp)
    assert delta.shape == (40, 9) and delta.dtype == torch.int32
    filt = np.unpackbits(np.asarray(pf).view(np.uint8), axis=-1,
                         bitorder="little")[..., :c]  # the -1 bits
    np.testing.assert_array_equal(
        delta.numpy(), c // 2 - filt.sum(-1, dtype=np.int64).reshape(40, 9))
    mask = outside_tap_mask(h, w, h, w, 3, 3, (1, 1), (1, 1), 1, 1)
    want = zero_padding_accum_correction(_t(pf), tp, mask)
    got = torch.einsum("yxt,ot->yxo", torch.from_numpy(
        mask.reshape(h, w, 9).astype(np.int32)), delta)
    assert torch.equal(got.to(torch.int32), want)
    layer = {"kind": "bconv", "packed_filter": pf, "channels_in": c,
             "padding": "SAME", "groups": 1}
    runtime = prepare_runtime_arrays({"z": dict(layer, pad_value=0),
                                      "o": dict(layer, pad_value=1)})
    np.testing.assert_array_equal(runtime["z"]["tap_delta"], delta.numpy())
    assert "tap_delta" not in runtime["o"]


@pytest.mark.parametrize("c", [32, 33, 64])
def test_zero_padding_is_supported(c):
    """The block kernel and the selection both take zero padding, odd
    depths too: the plain version's odd-depth term gives the accumulator
    the kernel's correction gives."""
    _, p = _params(c, pad_value=0)
    assert residual_block_supported((2, 8, 8, c), p, c, 3, 3)
    for pad_value in (0, 1):
        assert residual_applies("float", fh=3, fw=3, c_in=c,
                                pad_value=pad_value)
        assert not residual_applies("packed", fh=3, fw=3, c_in=c,
                                    pad_value=pad_value)
        assert not residual_applies("float", fh=3, fw=3, c_in=c,
                                    stride=(2, 2), pad_value=pad_value)


@pytest.mark.parametrize("shape", [(128, 56, 56, 64, 64), (1, 7, 7, 512, 512),
                                   (8, 14, 14, 256, 384), (3, 6, 5, 20, 20)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_is_the_same_for_both_paddings(shape, itemsize):
    """Blocks, warps and channel tiles do not depend on the padding; the
    zero-padded form's shared memory holds its [16][64] correction table and
    the tile's (64, 9) delta rows besides."""
    one = plan_residual_block(*shape, itemsize)
    zero = plan_residual_block(*shape, itemsize, zero_pad=True)
    assert {k: v for k, v in zero.items() if k != "smem_bytes"} == {
        k: v for k, v in one.items() if k != "smem_bytes"}
    assert zero["smem_bytes"] - one["smem_bytes"] == 4 * (16 * 64 + 64 * 9)
