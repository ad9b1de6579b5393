"""The port's binary GEMM (its plain version, on the CPU) against the JAX
package's Pallas ``bgemm`` in interpret mode, on the shapes of
tests/test_fast_kernels.py, in all four output kinds and in the K-blocked
(split-K) form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.kernels import bgemm as jbgemm_mod
from compute_engine_tpu.kernels.bgemm import bgemm as jbgemm

from compute_engine_tpu_torch.kernels.bgemm import (MAX_BLOCK_KW, bgemm,
                                                    bgemm_plain)


def _operands(rng, m, kw, n):
    lhs = rng.integers(0, 2 ** 32, size=(m, kw), dtype=np.uint32)
    rhs = rng.integers(0, 2 ** 32, size=(kw, n), dtype=np.uint32)
    return lhs, rhs


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _epilogue_args(rng, kw, n, kind):
    """Random per-channel operands of ``kind`` for both packages."""
    if kind == "bitpacked":
        thr = rng.integers(kw * 16 - 20, kw * 16 + 20, n).astype(np.int32)
        return dict(thresholds=thr)
    if kind in ("float", "int8"):
        # int8 needs values around the int8 range to exercise rounding and
        # saturation.
        scale = 4.0 if kind == "int8" else 1.0
        mul = (rng.uniform(-1, 1, n) * scale / kw).astype(np.float32)
        bias = rng.normal(0, 3, n).astype(np.float32)
        return dict(multiplier=mul, bias=bias, clamp_min=-20 * kw + 7,
                    clamp_max=30 * kw - 3)
    return {}


def _jax(lhs, rhs, kind, args, fn=jbgemm):
    jargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    return np.asarray(fn(jnp.asarray(lhs), jnp.asarray(rhs), out_kind=kind,
                         **jargs))


def _port(lhs, rhs, kind, args, **kw):
    out = bgemm(_t(lhs), _t(rhs), out_kind=kind, **args, **kw).numpy()
    return out.view(np.uint32) if kind == "bitpacked" else out


def _assert_matches(got, want, kind):
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "float":
        # One FMA rounding: JAX's compiler may contract mul + bias.
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["accum", "float", "int8", "bitpacked"])
def test_out_kinds_match_jax_at_a_ragged_shape(rng, kind):
    """M, KW and N are none of them a multiple of the kernel's tiles."""
    lhs, rhs = _operands(rng, 50, 7, 40)
    args = _epilogue_args(rng, 7, 40, kind)
    _assert_matches(_port(lhs, rhs, kind, args),
                    _jax(lhs, rhs, kind, args), kind)


@pytest.mark.parametrize("m,kw,n", [
    (7, 3, 5), (128, 18, 64), (200, 144, 130),
    (8, 288, 512),   # BinaryAlexNet's fc1 depth
    (40, 1100, 96),  # beyond MAX_BLOCK_KW: the K-blocked path in both
])
def test_accum_matches_jax(rng, m, kw, n):
    lhs, rhs = _operands(rng, m, kw, n)
    _assert_matches(_port(lhs, rhs, "accum", {}),
                    _jax(lhs, rhs, "accum", {}), "accum")
    assert (kw > MAX_BLOCK_KW) == (kw == 1100)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 40, 64, 127, 128])
def test_bitpacked_alignment_sweep_matches_jax(rng, n):
    """Padding bits of the last word stay 0 at every channel alignment."""
    lhs, rhs = _operands(rng, 48, 6, n)
    args = _epilogue_args(rng, 6, n, "bitpacked")
    got = _port(lhs, rhs, "bitpacked", args)
    _assert_matches(got, _jax(lhs, rhs, "bitpacked", args), "bitpacked")
    if n % 32:
        assert (got[:, -1] >> np.uint32(n % 32)).max() == 0


@pytest.mark.parametrize("m,kw,n", [(16, 144, 512), (16, 288, 4096)])
def test_bitpacked_wide_shapes_match_jax(rng, m, kw, n):
    """The single-strip and the bits8 epilogues of the JAX kernel."""
    lhs, rhs = _operands(rng, m, kw, n)
    args = _epilogue_args(rng, kw, n, "bitpacked")
    _assert_matches(_port(lhs, rhs, "bitpacked", args),
                    _jax(lhs, rhs, "bitpacked", args), "bitpacked")


@pytest.mark.parametrize("kind", ["accum", "float"])
def test_forced_split_k_with_ragged_tail_matches_jax_bigk(rng, kind,
                                                          monkeypatch):
    """JAX's K-blocked kernel, forced by a lowered weight-scratch budget
    (as tests/test_debug_checks.py does), against the port with its block
    depth lowered to 32 words: KW = 77 leaves a ragged tail in both."""
    monkeypatch.setattr(jbgemm_mod, "_WEIGHT_SCRATCH_BUDGET", 256 * 1024)
    m, kw, n = 40, 77, 50
    assert jbgemm_mod._pick_blocks(m, kw, n, plane_bytes=1)[3] == 2
    lhs, rhs = _operands(rng, m, kw, n)
    args = _epilogue_args(rng, kw, n, kind)
    # The unjitted function, so the lowered budget is read at this call.
    want = _jax(lhs, rhs, kind, args, fn=jbgemm.__wrapped__)
    got = _port(lhs, rhs, kind, args, max_block_kw=32)
    _assert_matches(got, want, kind)


def test_plain_takes_the_transposed_filter_view(rng):
    """The (KW, N) operand may be the transposed view of an (N, KW) filter,
    as the builder passes it."""
    lhs, rhs = _operands(rng, 9, 5, 33)
    filt = _t(np.ascontiguousarray(rhs.T))
    assert not filt.t().is_contiguous()
    a = bgemm_plain(_t(lhs), filt.t(), out_kind="accum")
    b = bgemm_plain(_t(lhs), _t(rhs), out_kind="accum")
    assert torch.equal(a, b)


def test_accum_is_the_popcount_of_xor(rng):
    lhs, rhs = _operands(rng, 6, 4, 7)
    want = np.zeros((6, 7), np.int64)
    for k in range(4):
        x = np.bitwise_xor(lhs[:, k, None], rhs[None, k, :])
        want += np.vectorize(lambda v: bin(v).count("1"))(x)
    np.testing.assert_array_equal(_port(lhs, rhs, "accum", {}), want)


def test_validation(rng):
    lhs, rhs = (_t(w) for w in _operands(rng, 4, 3, 8))
    with pytest.raises(ValueError, match="out_kind"):
        bgemm(lhs, rhs, out_kind="bits8")
    with pytest.raises(ValueError, match="not \\(M, KW\\)"):
        bgemm(lhs, rhs.t(), out_kind="accum")
    with pytest.raises(TypeError, match="int32"):
        bgemm(lhs.float(), rhs, out_kind="accum")
    with pytest.raises(ValueError, match="thresholds is required"):
        bgemm(lhs, rhs, out_kind="bitpacked")
    with pytest.raises(ValueError, match="multiplier needs shape"):
        bgemm(lhs, rhs, np.ones(3, np.float32), np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="max_block_kw"):
        bgemm(lhs, rhs, out_kind="accum", max_block_kw=0)
