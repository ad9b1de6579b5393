"""The arithmetic and the launch plans that the tensor-core kernels rely on.

The CUDA kernels (``csrc/bgemm.cu``, ``csrc/residual_block.cu``) run only on
the card. What they rely on is checked here on the CPU against the port's
own oracles: the AND-popcount identity with zero padding, the flat
padded-position indexing of the implicit GEMM, the MMA fragment's bitpacked
epilogue, the launch plans, the rebuild rule, and the bound that
``chip_smoke.py`` reckons for the one-bit route.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.core import bitpack, bitunpack
from compute_engine_tpu_torch.core.reference import extract_packed_patches
from compute_engine_tpu_torch.core.types import popcount, xor_popcount
from compute_engine_tpu_torch.kernels import _build
from compute_engine_tpu_torch.kernels import bgemm as bgemm_mod
from compute_engine_tpu_torch.kernels import residual as residual_mod
from compute_engine_tpu_torch.kernels.bgemm import bgemm_plain, plan_bgemm
from compute_engine_tpu_torch.kernels.residual import plan_residual_block
from compute_engine_tpu_torch.models import MODELS, get_model
from compute_engine_tpu_torch.models.builder import InitBuilder, _pair, _trace

MMA_WORDS = 8  # a one-bit MMA covers 256 bits of K


def _words(rng, shape):
    return torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32).view(np.int32))


def _pad_k(words, multiple=MMA_WORDS):
    pad = -words.shape[-1] % multiple
    return torch.nn.functional.pad(words, (0, pad))


def _and_popcount_accum(a, b):
    """accum[m, n] as the kernels form it: popcounts of rows and columns and
    the AND-popcount product, over K padded with zero words."""
    a, b = _pad_k(a), _pad_k(b)
    t = popcount(a[:, None, :] & b[None, :, :]).sum(-1)
    return (popcount(a).sum(-1)[:, None] + popcount(b).sum(-1)[None, :]
            - 2 * t)


@pytest.mark.parametrize("kw", [3, 75, 77])
def test_and_popcount_identity_with_ragged_k(rng, kw):
    a, b = _words(rng, (37, kw)), _words(rng, (21, kw))
    want = xor_popcount(a[:, None, :], b[None, :, :]).sum(-1)
    assert torch.equal(_and_popcount_accum(a, b), want)
    assert torch.equal(want.to(torch.int32),
                       bgemm_plain(a, b.t(), out_kind="accum"))


@pytest.mark.parametrize("c", [48, 64, 96])
def test_both_routes_equal_xor_popcount_with_channel_padding(rng, c):
    """9 taps of ``c`` channels: the padding bits of every word are 0 in
    both operands. The AND-popcount route needs no correction; the +-1 route
    needs the padding positions of one operand expanded to 0."""
    taps, m, n = 9, 19, 11
    a_pm1 = rng.choice([-1.0, 1.0], size=(m, taps, c)).astype(np.float32)
    b_pm1 = rng.choice([-1.0, 1.0], size=(n, taps, c)).astype(np.float32)
    a = bitpack(torch.from_numpy(a_pm1)).reshape(m, -1)
    b = bitpack(torch.from_numpy(b_pm1)).reshape(n, -1)
    want = xor_popcount(a[:, None, :], b[None, :, :]).sum(-1)
    assert torch.equal(_and_popcount_accum(a, b), want)

    cw = a.shape[1] // taps
    real = torch.arange(32 * cw) < c  # the real channels of a tap's words
    a_bytes = bitunpack(a.reshape(m, taps, cw), 32 * cw) * real
    b_bytes = bitunpack(b.reshape(n, taps, cw), 32 * cw)  # padding is +1
    t = a_bytes.reshape(m, -1) @ b_bytes.reshape(n, -1).t()
    assert torch.equal(((taps * c - t) / 2).to(torch.int64), want)


@pytest.mark.parametrize("kw", [3, 75, 77])
def test_popcounts_are_products_with_an_all_ones_operand(rng, kw):
    """The kernels take popc(row) and popc(column) from the MMA unit, as
    AND-popcount products with all-ones words; the zero words that pad K to
    whole MMAs add nothing to them."""
    a = _pad_k(_words(rng, (37, kw)))
    ones = torch.full((1, a.shape[1]), -1, dtype=torch.int32)
    got = popcount(a[:, None, :] & ones[None, :, :]).sum(-1)[:, 0]
    assert torch.equal(got, popcount(a[:, :kw]).sum(-1))


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bound_is_reckoned_against_the_one_bit_rate():
    """The kernels issue one-bit MMAs, eight times the int8 MMA's work an
    instruction, so the operations side of the bound takes eight times the
    int8 peak; at that rate the residual block is bound by bytes at every
    QuickNet shape, and BinaryAlexNet's GEMMs by bytes but for conv3 and
    conv4."""
    smoke = _chip_smoke()
    assert smoke.PEAK_ONE_BIT_OPS_PER_S == 8 * smoke.PEAK_INT8_OPS_PER_S
    name, m, kw, n, kind = smoke.ALEXNET_GEMMS[0]
    nbytes, ops = smoke.gemm_work(m, kw, n, kind)
    assert nbytes == 4 * (m * kw + n * kw + n + m * n // 32)
    assert ops == 2 * m * n * 32 * kw
    ms, by = smoke.bound(nbytes, ops)
    assert by == "bytes" and ms == nbytes / 3.35e12 * 1e3
    by = {name: smoke.bound(*smoke.gemm_work(m, kw, n, kind))[1]
          for name, m, kw, n, kind in smoke.ALEXNET_GEMMS}
    assert by == {"conv2": "bytes", "conv3": "operations",
                  "conv4": "operations", "conv5": "bytes", "fc1": "bytes",
                  "fc2": "bytes"}
    for shape in smoke.QUICKNET_BLOCKS:
        assert smoke.bound(*smoke.block_work(shape))[1] == "bytes"
    # A deep, narrow GEMM is still bound by its operations.
    assert smoke.bound(*smoke.gemm_work(4096, 4096, 4096, "float"))[1] == (
        "operations")


def _band_gather(packed, block, positions):
    """numpy model of ``residual_block.cu``: flat padded positions, a block's
    input band and the table of word offsets; returns (M, 9 CW padded to a
    multiple of 8) words of the block's output positions."""
    n, h, w, cw = packed.shape
    wp, plane = w + 2, (h + 2) * (w + 2)
    flat = np.zeros((n, h + 2, w + 2, cw), np.int32)
    flat[:, 1:-1, 1:-1] = packed
    flat = flat.reshape(n * plane, cw)
    q0 = block * positions
    band_rows = positions + 2 * wp + 2
    p = np.arange(q0 - wp - 1, q0 - wp - 1 + band_rows)
    ok = (p >= 0) & (p < n * plane)
    band = np.where(ok[:, None], flat[np.clip(p, 0, n * plane - 1)], 0)
    kw = 9 * cw
    kw_pad = -(-kw // MMA_WORDS) * MMA_WORDS
    koff = np.full(kw_pad, -1)
    for kk in range(kw):
        tap = kk // cw
        koff[kk] = ((tap // 3) * wp + tap % 3) * cw + kk % cw
    band = band.reshape(-1)
    rows = np.arange(positions)[:, None] * cw
    return np.where(koff[None, :] >= 0,
                    band[np.clip(rows + koff[None, :], 0, band.size - 1)], 0)


@pytest.mark.parametrize("w", [7, 9])
def test_flat_padded_positions_gather_the_nine_taps(rng, w):
    """One constant offset per tap, over a batch of images and over blocks
    that cross image borders, gives the one-padded im2col at every interior
    position."""
    n, h, cw, positions = 3, w, 2, 32
    packed = _words(rng, (n, h, w, cw))
    want = extract_packed_patches(packed, 3, 3, (1, 1), (1, 1), 1, 1, h, w)
    want = want.reshape(n, h, w, 9 * cw).numpy()
    plane, wp = (h + 2) * (w + 2), w + 2
    blocks = -(-n * plane // positions)
    got = np.concatenate([_band_gather(packed.numpy(), b, positions)
                          for b in range(blocks)])[:n * plane]
    assert np.all(got[:, 9 * cw:] == 0)  # the words that pad K
    got = got[:, :9 * cw].reshape(n, h + 2, wp, 9 * cw)
    assert np.array_equal(got[:, 1:-1, 1:-1], want)


def test_fragment_quad_or_is_bitpack(rng):
    """The bitpacked epilogue of ``bgemm.cu``: lane (g, t) of a warp holds
    channels 2t and 2t + 1 of rows g and g + 8 of every 8-column MMA tile;
    the OR over the four lanes of a quad of the bits of four neighbouring
    tiles is the packed word, LSB first."""
    n_real = 27  # channels >= N vote 0
    acc = rng.integers(-50, 50, size=(16, 32))
    thr = rng.integers(-10, 10, size=32)
    words = np.zeros(16, np.uint32)
    for g in range(8):
        for half in range(2):
            row = g + 8 * half
            for t in range(4):
                for jj in range(4):
                    for q in range(2):
                        col = 8 * jj + 2 * t + q
                        if col < n_real and acc[row, col] > thr[col]:
                            words[row] |= np.uint32(1 << (8 * jj + 2 * t + q))
    want = bitpack(torch.from_numpy(acc[:, :n_real] > thr[:n_real]))
    assert np.array_equal(words.view(np.int32), want.numpy()[:, 0])


class _ShapeRecorder(InitBuilder):
    """Traces a model on the meta device and records its binary layers."""

    def __init__(self):
        super().__init__(seed=0)
        self.convs, self.denses = [], []

    def binary_conv_bn(self, x, filters, ksize, *, stride=1, padding="SAME",
                       pad_value=1, name, groups=1, dilation=1,
                       input_shift=False):
        y = super().binary_conv_bn(x, filters, ksize, stride=stride,
                                   padding=padding, pad_value=pad_value,
                                   name=name, groups=groups,
                                   dilation=dilation,
                                   input_shift=input_shift)
        self.convs.append((name, tuple(x.shape), tuple(y.shape), _pair(ksize),
                           _pair(stride), padding, pad_value, groups,
                           _pair(dilation)))
        return y

    def binary_dense_bn(self, x, units, *, name):
        self.denses.append((name, x.shape[-1], units))
        return super().binary_dense_bn(x, units, name=name)


def _check_plan(plan, what):
    assert plan["smem_bytes"] <= residual_mod.MAX_SHARED_BYTES, (what, plan)
    assert plan["grid"][0] < 2 ** 31 and max(plan["grid"][1:]) <= 65535, what
    assert plan["blocks"] == int(np.prod(plan["grid"]))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_launch_plans_fit_the_card_for_every_zoo_layer(model):
    """Every binary conv and dense of the zoo at batch 128: shared memory
    within what a block may use, grid within the limits, and at least one
    block for every SM (the dense layers, with 128 rows, through the smaller
    tile)."""
    batch = 128
    rec = _ShapeRecorder()
    _trace(get_model(model), rec)
    assert rec.convs
    for (name, xs, ys, (kh, kw), stride, padding, pad_value, groups,
         dilation) in rec.convs:
        _, h, w, c = xs
        _, oh, ow, co = ys
        words = kh * kw * -(-(c // groups) // 32)
        plan = plan_bgemm(batch * oh * ow, co // groups, words,
                          min(words, bgemm_mod.MAX_BLOCK_KW))
        _check_plan(plan, (model, name, "bgemm"))
        assert plan["blocks"] >= bgemm_mod.SM_COUNT, (model, name, plan)
        if ((kh, kw) == (3, 3) and stride == (1, 1) and padding == "SAME"
                and pad_value == 1 and groups == 1 and dilation == (1, 1)):
            for itemsize in (2, 4):
                plan = plan_residual_block(batch, h, w, c, co, itemsize)
                _check_plan(plan, (model, name, "residual"))
                assert plan["blocks"] >= residual_mod.SM_COUNT, (model, name)
    for name, c, units in rec.denses:
        plan = plan_bgemm(batch, units, -(-c // 32), bgemm_mod.MAX_BLOCK_KW)
        _check_plan(plan, (model, name, "dense"))
        assert plan["tile"] == (64, 32)
        assert plan["blocks"] >= bgemm_mod.SM_COUNT, (model, name, plan)


@pytest.mark.parametrize("shape,c_out,warps,tiles,blocks", [
    ((128, 56, 56, 64), 64, 8, 1, 1682), ((128, 28, 28, 128), 128, 8, 2, 450),
    ((128, 14, 14, 256), 256, 8, 2, 256), ((128, 7, 7, 512), 512, 4, 2, 324),
    ((128, 13, 13, 256), 384, 8, 2, 339), ((128, 7, 7, 64), 64, 2, 1, 162),
    ((4, 9, 9, 48), 48, 2, 1, 8)])
def test_residual_plan_at_the_main_path_shapes(shape, c_out, warps, tiles,
                                               blocks):
    plan = plan_residual_block(*shape, c_out)
    assert (plan["warps"], plan["tiles_per_block"], plan["blocks"]) == (
        warps, tiles, blocks)
    n, h, w, c = shape
    assert plan["grid"][0] * 32 * warps >= n * (h + 2) * (w + 2)
    assert plan["grid"][1] * tiles * 64 >= c_out


def test_residual_plan_takes_a_given_block_size():
    plan = plan_residual_block(128, 7, 7, 512, 512, 2, warps=2,
                               tiles_per_block=8)
    assert (plan["warps"], plan["tiles_per_block"]) == (2, 8)
    assert plan["grid"] == (162, 1) and plan["blocks"] == 162
    small = plan_residual_block(128, 7, 7, 512, 512, 2, warps=2,
                                tiles_per_block=1)
    assert small["smem_bytes"] == plan["smem_bytes"]
    wide = plan_residual_block(128, 7, 7, 512, 512, 4, warps=2,
                               tiles_per_block=1)
    assert wide["smem_bytes"] == plan["smem_bytes"] + 2 * 64 * 72


@pytest.mark.parametrize("m,kw,n,block_kw,tile,grid", [
    (93312, 75, 256, 1024, (128, 64), (729, 4, 1)),
    (128, 288, 4096, 1024, (64, 32), (2, 128, 1)),
    (1000, 77, 100, 32, (64, 32), (16, 4, 3)),
    (21632, 108, 384, 32, (128, 64), (169, 6, 4)),
    (1000, 77, 100, 1024, (64, 32), (16, 4, 1))])
def test_bgemm_plan(m, kw, n, block_kw, tile, grid):
    plan = plan_bgemm(m, n, kw, block_kw)
    assert plan["tile"] == tile and plan["grid"] == grid
    if tile == (128, 64):
        assert plan["blocks"] >= bgemm_mod.SM_COUNT or block_kw < kw


@pytest.mark.parametrize("index,m,kw,n,grid", [
    (0, 401408, 18, 64, (3136, 1, 1)), (1, 100352, 36, 128, (784, 2, 1)),
    (2, 25088, 72, 256, (196, 4, 1)), (3, 6272, 144, 512, (49, 8, 1))])
def test_bgemm_plan_at_the_int8_pipeline_shapes(index, m, kw, n, grid):
    """QuickNet's binary convs at batch 128 in the int8 pipeline: one pass
    over K in the large tile, every SM busy, and a bound that counts one
    byte per int8 output and is set by bytes."""
    smoke = _chip_smoke()
    assert smoke.QUICKNET_INT8_GEMMS[index][1:] == (m, kw, n)
    plan = plan_bgemm(m, n, kw, min(kw, bgemm_mod.MAX_BLOCK_KW))
    _check_plan(plan, ("quicknet int8", index))
    assert plan["tile"] == (128, 64) and plan["grid"] == grid
    assert plan["blocks"] >= bgemm_mod.SM_COUNT
    nbytes, ops = smoke.gemm_work(m, kw, n, "int8")
    assert nbytes == 4 * m * kw + 4 * n * kw + 8 * n + m * n
    assert nbytes < smoke.gemm_work(m, kw, n, "float")[0]
    assert ops == 2 * m * n * 32 * kw
    assert smoke.bound(nbytes, ops)[1] == "bytes"


def test_build_target_changes_with_a_shared_header(tmp_path, monkeypatch):
    """A source is rebuilt when any header under csrc/ changes."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert _build.sources() == ["a"] and _build.headers() == ["shared.cuh"]
    first = _build._target("a")[1]
    assert _build._target("a")[1] == first
    (csrc / "shared.cuh").write_text("// two\n")
    second = _build._target("a")[1]
    assert second != first
    (csrc / "extra.h").write_text("// new header\n")
    assert _build._target("a")[1] not in (first, second)
    (csrc / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target("a")[1] != second


def test_every_source_of_the_port_has_a_build_target():
    assert {"bgemm", "residual_block", "mma_rate"} <= set(_build.sources())
    assert "mma_binary.cuh" in _build.headers()
    targets = {_build._target(name)[1] for name in _build.sources()}
    assert len(targets) == len(_build.sources())
