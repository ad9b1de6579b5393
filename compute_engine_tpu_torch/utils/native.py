"""ctypes binding of the native host library (``csrc/bitpack.cc``).

``libce_host`` is built with ``g++`` the first time it is needed, into the
package's ``build/`` directory (beside the CUDA libraries, named by a hash of
its source), and loaded with ``ctypes``. It is a host library, not a GPU
kernel, and lies on no device path: host-side packing (the converter, input
pipelines) runs through it at native speed. Every entry point returns None
where there is no compiler, and its callers then use numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..kernels import _build

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(_build.CSRC, "bitpack.cc")
_FLAGS = ["-O3", "-shared", "-fPIC"]


def _build_and_load():
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read())
    except OSError:
        return None
    out = os.path.join(_build.BUILD_DIR,
                       f"libce_host-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        try:
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
            os.close(fd)
        except OSError:
            return None
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, out)  # whole or not there, for a parallel reader
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    i64 = ctypes.c_int64
    lib.ce_bitpack_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        i64, i64]
    lib.ce_bitpack_f32.restype = None
    lib.ce_bitpack_i8.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint32),
        i64, i64, ctypes.c_int32]
    lib.ce_bitpack_i8.restype = None
    lib.ce_unpack_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_float),
        i64, i64, ctypes.c_float, ctypes.c_float]
    lib.ce_unpack_f32.restype = None
    return lib


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def native_bitpack(x, zero_point: int = 0):
    """Native host bitpack; returns None if the library is unavailable or
    the dtype unsupported. Same semantics as ``core.bitpack.bitpack_np``."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    cols = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64)) if x.ndim > 1 else 1
    packed_cols = -(-cols // 32)
    out = np.empty((*x.shape[:-1], packed_cols), np.uint32)
    if x.dtype == np.float32:
        if zero_point != 0:
            return None
        lib.ce_bitpack_f32(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            rows, cols)
    elif x.dtype == np.int8:
        lib.ce_bitpack_i8(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            rows, cols, zero_point)
    else:
        return None
    return out


def native_unpack(packed, channels: int, zero_bit=1.0, one_bit=-1.0):
    """Native host unpack to float32; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint32)
    if packed.shape[-1] != -(-channels // 32):
        raise ValueError(
            f"packed last dim {packed.shape[-1]} does not match "
            f"channels={channels}")
    rows = int(np.prod(packed.shape[:-1], dtype=np.int64)) \
        if packed.ndim > 1 else 1
    out = np.empty((*packed.shape[:-1], channels), np.float32)
    lib.ce_unpack_f32(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows, channels, zero_bit, one_bit)
    return out
