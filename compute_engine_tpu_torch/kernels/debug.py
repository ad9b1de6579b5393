"""Debug checks of the kernels: the counterpart of ``pl.debug_check``.

The Pallas kernels of the JAX package assert four invariants that are
compiled out unless ``pl.enable_debug_checks()`` is on:

  bit 1  the GEMM: the +-1 sum ``t`` of every output is bounded by the bits
         it sums, ``|t| <= total_bits`` (``kernels/bgemm.py:225-228``)
  bit 2  split-K: a block of K's sum, and the reduced sum, are bounded by
         their real bit counts (the big-K pad count, ``bgemm.py:284-287``)
  bit 4  a bitpacked output word has no bit set at or beyond N (the port's
         analogue of the lane-pack's uint16 range, ``bgemm.py:173-177``:
         the port packs by OR, not by matmul)
  bit 8  the residual block: ``|t| <= K = 9 C`` (``residual.py:118-120``)

and the port adds checks of its own kernels, which no Pallas kernel has:

  bit 16 the stem (``kernels/stem.py``): every operand its implicit GEMM
         reads lies inside the input patch it staged in shared memory
  bit 32 the residual block's tail form (``kernels/residual.py``): no
         store lands on a channel that the launch reads ``x`` at
  bit 64 the transition (``kernels/transition.py``): every operand its
         GEMM reads lies inside the input tile and the filter chunk it
         staged in shared memory

Inside ``debug_checks()`` the wrappers load a build of each kernel with
``-DCE_DEBUG_CHECKS`` (a library of its own; the default build compiles
none of the checks). A broken invariant sets its bit in an int32 error word
on the card; after the launch the wrapper reads and clears the word and
raises ``RuntimeError`` naming each broken invariant, in the spirit of
``checkify``'s error value. No device-side ``assert``: that would leave the
CUDA context unusable for the rest of the process. On CPU tensors the plain
versions hold the same inequalities inside ``debug_checks()``.

The wrappers' private overrides (``_debug_total_bits``, ``_debug_vote_n``,
``_debug_k``, ``_debug_patch_elems``, ``_debug_overlap``,
``_debug_tile_elems``) stand for the
accounting bugs the checks guard against, so that a test trips each check
on purpose; only a call inside
``debug_checks()`` takes them. ``_debug_vote_n`` breaks the GEMM kernel's
vote loop and so exists on the card only; on the CPU a test widens the
operands itself and holds the result to ``bgemm.check_padding_bits``.

The switch is a context variable: it holds in the thread (or task) that
enters the block, not in threads that thread starts. The checks are an
eager tool: a compiled forward (``runtime.compiled``) refuses to run inside
the block, and ``begin`` refuses a launch that a CUDA graph captures.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

__all__ = ["debug_checks", "enabled", "CHECKS", "NOT_CAPTURED", "raise_for",
           "begin", "end", "require_enabled"]

CHECKS = {
    1: "bgemm: |pm1 contraction| > total_bits — unpack/total_bits "
       "accounting broken",
    2: "bgemm split-K: corrected contraction exceeds the real bit count — "
       "K-block accounting broken",
    4: "bgemm: bitpacked output has a bit set at or beyond N — padding-bit "
       "invariant broken",
    8: "residual: |pm1 conv| > K — tap matrix or one-padding invariant "
       "broken",
    16: "stem: an operand read outside the staged input patch — tap table "
        "or tile geometry broken",
    32: "residual tail form: a store on a channel the launch reads — the "
        "output overlaps its input",
    64: "transition: an operand read outside the staged tile — tile "
        "geometry broken",
}

_ENABLED = contextvars.ContextVar("ce_debug_checks", default=False)

NOT_CAPTURED = ("the kernels' debug builds wait for each launch to read its "
                "error word, so a forward under kernels.debug_checks() cannot "
                "be captured in a CUDA graph; run packed_apply eagerly inside "
                "debug_checks()")


@contextlib.contextmanager
def debug_checks():
    """Run the kernels' debug builds, and the plain versions' checks, inside
    the block (the counterpart of ``pl.enable_debug_checks()``)."""
    token = _ENABLED.set(True)
    try:
        yield
    finally:
        _ENABLED.reset(token)


def enabled() -> bool:
    return _ENABLED.get()


def require_enabled(**overrides):
    """Raise if an override is given outside ``debug_checks()``: the default
    build has no checks to trip."""
    given = sorted(k for k, v in overrides.items() if v is not None)
    if given and not enabled():
        raise ValueError(f"{', '.join(given)} needs kernels.debug_checks()")


def raise_for(word: int) -> None:
    """Raise ``RuntimeError`` naming every check whose bit is set."""
    if word:
        broken = [msg for bit, msg in CHECKS.items() if word & bit]
        raise RuntimeError("kernel debug check failed: " + "; ".join(broken))


def bind(lib) -> None:
    """Declare the debug library's entry points (once per library)."""
    if lib.ce_debug_begin.argtypes is None:
        lib.ce_debug_begin.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.ce_debug_begin.restype = ctypes.c_int
        lib.ce_debug_end.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.ce_debug_end.restype = ctypes.c_int


def begin(lib, stream, declared_bits=None, vote_n=None) -> None:
    """Clear the error word and set the overrides before a launch. Raises
    while the current stream captures a CUDA graph: ``end`` waits for the
    launch, which a capture cannot do."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(NOT_CAPTURED)
    bind(lib)
    rc = lib.ce_debug_begin(int(declared_bits or 0), int(vote_n or 0),
                            stream)
    if rc != 0:
        raise RuntimeError("debug check setup failed: "
                           + lib.ce_error_string(rc).decode())


def end(lib, stream) -> None:
    """Wait for the launch, read and clear the error word, and raise for
    every broken invariant."""
    word = ctypes.c_int(0)
    rc = lib.ce_debug_end(stream, ctypes.byref(word))
    if rc != 0:
        raise RuntimeError("debug check readout failed: "
                           + lib.ce_error_string(rc).decode())
    raise_for(word.value)
