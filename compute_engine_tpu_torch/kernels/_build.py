"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` under the package
(a directory the repository's ``.gitignore`` lists) with a plain C interface,
loaded with ``ctypes``. The hash covers the source, every header under
``csrc/`` that a source can include (``*.cuh``, ``*.h``) and the flags, so an
edit to any of them rebuilds. ``build_all`` starts one ``nvcc`` per source,
all at once. Only the sources in this package are compiled; a failed build
raises.

A debug build (``debug=True``) adds ``DEBUG_FLAGS``, which compile the
kernels' debug checks (``csrc/debug_checks.cuh``, ``kernels/debug.py``);
its flags differ, so it is a library of its own,
``build/<name>-debug-<hash>.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
DEBUG_FLAGS = ["-DCE_DEBUG_CHECKS"]

_lock = threading.Lock()
_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers() -> list[str]:
    """Names of the headers under ``csrc/`` that a source may include."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))


def _flags(debug: bool) -> list[str]:
    return NVCC_FLAGS + DEBUG_FLAGS if debug else NVCC_FLAGS


def _label(name: str, debug: bool) -> str:
    return f"{name}-debug" if debug else name


def _target(name: str, debug: bool = False) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(_flags(debug)).encode())
    for path in [src, *(os.path.join(CSRC, h) for h in headers())]:
        with open(path, "rb") as f:
            digest.update(b"\0" + os.path.basename(path).encode() + b"\0"
                          + f.read())
    return src, os.path.join(
        BUILD_DIR, f"{_label(name, debug)}-{digest.hexdigest()[:16]}.so")


def _start(name: str, debug: bool = False):
    """Start ``nvcc`` for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    src, target = _target(name, debug)
    if os.path.exists(target):
        return None
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen([nvcc, *_flags(debug), "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    _logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all(debug=()) -> dict[str, str]:
    """Build every source, and the debug build of each source named in
    ``debug``, all in parallel; returns the compiler output by library
    (``<name>`` or ``<name>-debug``; empty for one already built)."""
    with _lock:
        jobs = {(name, False): _start(name) for name in sources()}
        jobs.update({(name, True): _start(name, True) for name in debug})
        errors = []
        for (name, dbg), job in jobs.items():
            if job is None:
                continue
            try:
                _finish(_label(name, dbg), job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {_label(*key): _logs.get(_label(*key), "") for key in jobs}


def load(name: str, debug: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (its debug build with
    ``debug``), built first if needed."""
    key = (name, debug)
    with _lock:
        if key not in _libs:
            job = _start(name, debug)
            if job is not None:
                _finish(_label(name, debug), job)
            _libs[key] = ctypes.CDLL(_target(name, debug)[1])
        return _libs[key]
