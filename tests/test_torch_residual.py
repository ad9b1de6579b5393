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


# -- strided operands: a channel prefix in, a channel slice out --------------

# (n, h, w, c, width of the buffer, offset of out's slice, dtype): a dense
# block's layer reads the stream's first c channels of a wider buffer and
# writes its 64 channels after them; a ragged depth and a slice after a gap;
# one pixel, whose channel slices PyTorch counts as dense.
STRIDED_CASES = [(2, 6, 6, 64, 192, 64, "bfloat16"),
                 (1, 5, 7, 96, 160, 96, "float32"),
                 (3, 4, 4, 33, 128, 40, "bfloat16"),
                 (2, 3, 5, 128, 256, 192, "float32"),
                 (1, 1, 1, 64, 192, 64, "bfloat16")]


@pytest.mark.parametrize("pad_value", [1, 0])
@pytest.mark.parametrize("n,h,w,c,width,at,dtype", STRIDED_CASES)
def test_block_reads_a_channel_prefix_and_writes_a_slice(
        rng, n, h, w, c, width, at, dtype, pad_value):
    """Without the add, the block reading ``buf[..., :c]`` and writing
    ``out=buf[..., at:at + 64]`` leaves the buffer equal to the dense call
    copied into place, every other channel untouched, at both paddings."""
    x, pf, tr = _case(rng, n, h, w, c, c_out=64)
    _, tp = _params(c, pad_value=pad_value)
    dt = getattr(torch, dtype)
    buf = torch.from_numpy(
        rng.normal(0, 1, (n, h, w, width)).astype(np.float32)).to(dt)
    buf[..., :c] = torch.from_numpy(x).to(dt)
    want = buf.clone()
    want[..., at:at + 64] = binary_residual_block(
        buf[..., :c].contiguous(), _t(pf), tr, tp, has_residual=False)
    got = binary_residual_block(buf[..., :c], _t(pf), tr, tp,
                                has_residual=False,
                                out=buf[..., at:at + 64])
    assert got.data_ptr() == buf[..., at:].data_ptr()
    assert torch.equal(buf, want)


def _strided_refusals():
    """(x, out, has_residual, the error's words) that the block refuses,
    over a (2, 4, 4, 192) float32 buffer and a C = 64 input."""
    buf = torch.zeros(2, 4, 4, 192)
    return [
        # a channel stride of 2 in x, then in out
        (buf[..., :128:2], None, False, "x must be dense NHWC"),
        (buf[..., :64], buf[..., 64::2], False, "out must be dense NHWC"),
        # out of the wrong width, of the wrong dtype
        (buf[..., :64], buf[..., 64:96], False, "out must be"),
        (buf[..., :64], torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16),
         False, "out must be"),
        # out over the channels x reads
        (buf[..., :64], buf[..., 32:96], False, "overlaps"),
        # pixels that are not one row each
        (buf[:, :2, :, :64].permute(0, 2, 1, 3), None, False,
         "x must be dense NHWC"),
        # a channel prefix under the add
        (buf[..., :64], None, True, "residual forms"),
        # the tail form: a tail narrower than C_out, an out over the
        # channels x reads, an out of the wrong width
        (buf[..., :32], None, "tail", "x has 32"),
        (buf[..., :128], buf[..., 64:128], "tail", "overlaps"),
        (buf[..., :128], buf[..., 128:160], "tail", "out must be"),
    ]


@pytest.mark.parametrize("case", range(len(_strided_refusals())))
@pytest.mark.parametrize("version", ["wrapper", "plain"])
def test_block_refuses_other_layouts(rng, case, version):
    """Neither the wrapper nor the plain version copies an operand to make
    it fit: a non-unit channel stride, an ``out`` of the wrong shape or
    dtype or over the channels ``x`` reads, a layout that is not one row a
    pixel, a channel prefix under the add of ``x`` itself, a tail form
    reading more channels than ``x`` has: each raises."""
    x, out, residual, words = _strided_refusals()[case]
    _, pf, tr = _case(rng, 1, 1, 1, x.shape[-1], c_out=64)
    _, tp = _params(x.shape[-1])
    fn = (binary_residual_block if version == "wrapper"
          else binary_residual_block_plain)
    with pytest.raises(ValueError, match=words):
        fn(x, _t(pf), tr, tp, has_residual=residual, out=out)


# -- the tail form: the add of x's last C_out channels ------------------------

# (n, h, w, c, c_out, width of the buffer, dtype): a stream's first c
# channels of a wider buffer (MeliusNet's improvement: c_out 64), an input
# as wide as its buffer, C == C_out, ragged depths, one pixel.
TAIL_CASES = [(2, 6, 6, 128, 64, 192, "bfloat16"),
              (1, 5, 7, 96, 32, 96, "float32"),
              (3, 4, 4, 64, 64, 128, "bfloat16"),
              (2, 3, 5, 80, 48, 160, "float32"),
              (1, 1, 1, 192, 64, 256, "bfloat16")]


@pytest.mark.parametrize("pad_value", [1, 0])
@pytest.mark.parametrize("version", ["wrapper", "plain"])
@pytest.mark.parametrize("n,h,w,c,c_out,width,dtype", TAIL_CASES)
def test_tail_form_is_the_conv_then_the_tail_add(rng, n, h, w, c, c_out,
                                                 width, dtype, version,
                                                 pad_value):
    """The tail form on a channel prefix ``buf[..., :c]`` is the conv with
    its BN (the packed oracle's, rounded to the activation type) added to
    the prefix's last C_out channels, bit for bit: into a new tensor, the
    buffer untouched, and into an ``out`` slot after the prefix, every
    other channel of the buffer untouched."""
    x, pf, tr = _case(rng, n, h, w, c, c_out=c_out)
    _, tp = _params(c, pad_value=pad_value)
    dt = getattr(torch, dtype)
    buf = torch.from_numpy(
        rng.normal(0, 1, (n, h, w, width)).astype(np.float32)).to(dt)
    buf[..., :c] = torch.from_numpy(x).to(dt)
    before = buf.clone()
    stream = buf[..., :c]
    y = bconv2d_reference(bitpack(stream.contiguous()), _t(pf), tr,
                          tp).to(dt)
    want = stream[..., c - c_out:] + y
    fn = (binary_residual_block if version == "wrapper"
          else binary_residual_block_plain)
    got = fn(stream, _t(pf), tr, tp, has_residual="tail")
    assert torch.equal(got, want)
    assert torch.equal(buf, before)
    if width - c >= c_out:
        fn(stream, _t(pf), tr, tp, has_residual="tail",
           out=buf[..., c:c + c_out])
        before[..., c:c + c_out] = want
        assert torch.equal(buf, before)


@pytest.mark.parametrize("c,c_out,want", [(128, 64, True), (64, 64, True),
                                          (32, 64, False)])
def test_tail_form_is_supported_where_the_tail_is_wide_enough(c, c_out,
                                                              want):
    """The tail form takes an input at least C_out wide; the add of ``x``
    itself as wide as C_out; ``has_residual`` is True, False or
    "tail"."""
    _, tp = _params(c, pad_value=0)
    assert residual_block_supported((2, 4, 4, c), tp, c_out, 3, 3,
                                    "tail") is want
    assert residual_block_supported((2, 4, 4, c), tp, c_out, 3, 3,
                                    True) is (c == c_out)
    with pytest.raises(ValueError, match="True, False or 'tail'"):
        residual_block_supported((2, 4, 4, c), tp, c_out, 3, 3, "head")
