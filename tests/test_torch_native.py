"""The port's native host library (its own ``csrc/bitpack.cc``, built with
g++ into the package's build directory) against ``bitpack_np``'s numpy path
and the JAX package's ``bitpack_np``."""

import os
import shutil
import sys

import numpy as np
import pytest

from compute_engine_tpu.core.bitpack import bitpack_np as jbitpack_np

import compute_engine_tpu_torch.core.bitpack  # noqa: F401  (the module)
from compute_engine_tpu_torch.kernels import _build
from compute_engine_tpu_torch.utils import native

bitpack_mod = sys.modules["compute_engine_tpu_torch.core.bitpack"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_pack(x, zero_point=0):
    """``bitpack_np`` with the native library out of the way."""
    saved = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True
    try:
        return bitpack_mod.bitpack_np(x, zero_point)
    finally:
        native._LIB, native._TRIED = saved


@pytest.fixture
def lib(tmp_path, monkeypatch):
    """The library built afresh into a temporary build directory."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    lib = native.get_lib()
    assert lib is not None
    built = os.listdir(tmp_path)
    assert len(built) == 1 and built[0].startswith("libce_host-")
    assert built[0].endswith(".so")
    return lib


@pytest.mark.parametrize("cols", [1, 31, 32, 33, 100, 512])
def test_native_pack_f32(lib, cols, rng):
    x = rng.normal(0, 1, (7, cols)).astype(np.float32)
    x[0, 0], x[1, 0] = 0.0, -0.0  # both are +1: bit 0
    got = native.native_bitpack(x)
    assert got.dtype == np.uint32 and got.shape == (7, -(-cols // 32))
    np.testing.assert_array_equal(got, _numpy_pack(x))
    np.testing.assert_array_equal(got, jbitpack_np(x))
    np.testing.assert_array_equal(bitpack_mod.bitpack_np(x), got)


@pytest.mark.parametrize("zp", [-128, -5, 0, 3, 127, 200])
def test_native_pack_i8_with_zero_points(lib, zp, rng):
    x = rng.integers(-128, 128, size=(5, 70), dtype=np.int8)
    got = native.native_bitpack(x, zp)
    np.testing.assert_array_equal(got, _numpy_pack(x, zp))
    np.testing.assert_array_equal(bitpack_mod.bitpack_np(x, zp), got)


def test_native_unpack_roundtrip(lib, rng):
    x = np.sign(rng.standard_normal((4, 97))).astype(np.float32)
    x[x == 0] = 1.0
    packed = native.native_bitpack(x)
    np.testing.assert_array_equal(native.native_unpack(packed, 97), x)
    np.testing.assert_array_equal(
        native.native_unpack(packed, 97, zero_bit=0.0, one_bit=1.0),
        (x < 0).astype(np.float32))
    with pytest.raises(ValueError, match="does not match"):
        native.native_unpack(packed, 129)


def test_native_pack_3d_and_strided(lib, rng):
    x = rng.normal(0, 1, (2, 3, 65)).astype(np.float32)
    np.testing.assert_array_equal(native.native_bitpack(x), _numpy_pack(x))
    xt = np.transpose(rng.normal(0, 1, (65, 6)).astype(np.float32))
    assert not xt.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(native.native_bitpack(xt), _numpy_pack(xt))


def test_unsupported_inputs_fall_to_numpy(lib, rng):
    assert native.native_bitpack(np.zeros((2, 8), np.float64)) is None
    assert native.native_bitpack(np.zeros((2, 8), np.float32), 1) is None
    with pytest.raises(ValueError, match="zero_point must be 0"):
        bitpack_mod.bitpack_np(np.zeros((2, 8), np.float32), 1)
    b = rng.integers(0, 2, (3, 40)).astype(bool)
    np.testing.assert_array_equal(bitpack_mod.bitpack_np(b), jbitpack_np(b))


def test_without_a_compiler_every_entry_point_returns_none(tmp_path,
                                                           monkeypatch, rng):
    """No g++: ``get_lib`` is None, the entry points return None and
    ``bitpack_np`` packs with numpy; nothing is left in the build directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.get_lib() is None
    x = rng.normal(0, 1, (3, 40)).astype(np.float32)
    assert native.native_bitpack(x) is None
    assert native.native_unpack(np.zeros((3, 2), np.uint32), 40) is None
    np.testing.assert_array_equal(bitpack_mod.bitpack_np(x), jbitpack_np(x))
    assert os.listdir(tmp_path) == []


def test_the_source_is_the_ports_own_and_no_cuda_source():
    assert native._SRC == os.path.join(REPO, "compute_engine_tpu_torch",
                                       "csrc", "bitpack.cc")
    assert os.path.exists(native._SRC)
    assert "bitpack" not in _build.sources()  # only *.cu are kernel sources
    assert all(os.path.exists(os.path.join(_build.CSRC, f"{s}.cu"))
               for s in _build.sources())
