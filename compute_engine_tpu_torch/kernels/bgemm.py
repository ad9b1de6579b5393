"""Binary GEMM on packed words with a fused output transform.

``bgemm`` is the port of the Pallas kernels
``compute_engine_tpu.kernels.bgemm._bgemm_kernel`` and, for deep K,
``_bgemm_kernel_bigk``: on CUDA tensors it launches the hand-written kernel
in ``csrc/bgemm.cu`` (single-bit ``mma.sync`` on the tensor cores, AND +
popcount, with ``popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b)``; one pass
over K, or split-K with a reduction pass when KW exceeds ``max_block_kw``);
on CPU tensors it runs ``bgemm_plain``, the plain PyTorch version of the same
function. ``plan_bgemm`` is the launch plan (tile, grid, shared memory) in
Python, where the CPU tests can check it; every shape takes this kernel.

Contract (that of the JAX ``bgemm``):

  lhs  (M, KW) int32 words (im2col patches / dense activations)
  rhs  (KW, N) int32 words (the filter, K-major); the transposed view of a
       contiguous (N, KW) filter is read as it is, without a copy
  accum[m, n] = sum_k popcount(lhs[m, k] ^ rhs[k, n])

  out_kind "accum"      int32 (M, N)
           "float"      float32 (M, N): clip(2*accum, cmin, cmax) * mul + bias
           "int8"       int8 (M, N): the float value rounded half away from
                        zero and clipped to [-128, 127]
           "bitpacked"  int32 words (M, ceil(N/32)): bit n set where
                        accum > thresholds[n], LSB first, padding bits 0

Channel-padding bits are 0 in both operands and add nothing to any popcount.
The float epilogue rounds the product and the sum separately (no FMA), so
the kernel equals the plain version bit for bit.

Inside ``kernels.debug_checks()`` the kernel's debug build runs, and the
plain version checks, the invariants of the Pallas kernels' debug checks
(``kernels/debug.py``): ``|t| <= total_bits`` (one pass; split-K), and no
bit at or beyond N in a bitpacked word.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.bitpack import bitpack, bitunpack
from ..core.types import BITWIDTH, PACKED_DTYPE, ceil_div
from . import counts, debug

__all__ = ["bgemm", "bgemm_plain", "plan_bgemm", "uses_split_k", "OUT_KINDS",
           "MAX_BLOCK_KW", "check_padding_bits"]

SM_COUNT = 132                 # H100 SXM
_STAGES, _STAGE_KW, _ROW_STRIDE, _COLUMN_PAD = 2, 32, 36, 8

OUT_KINDS = ("accum", "float", "int8", "bitpacked")
_KIND_CODES = {kind: i for i, kind in enumerate(OUT_KINDS)}
_OUT_DTYPES = {"accum": torch.int32, "float": torch.float32,
               "int8": torch.int8, "bitpacked": PACKED_DTYPE}

# K depth (in words) above which the GEMM is split across blocks: the
# counterpart of the JAX kernel's weight-scratch budget, under which its
# int8 planes switch to the K-blocked grid at KW > 1024 words.
MAX_BLOCK_KW = 1024


def uses_split_k(kw: int, max_block_kw: int = MAX_BLOCK_KW) -> bool:
    """Whether a GEMM of ``kw`` words of K runs split over K."""
    return kw > max_block_kw


CLAMP_MIN_DEFAULT = -(2 ** 31) + 1
CLAMP_MAX_DEFAULT = 2 ** 31 - 1


def _vector(v, dtype, device, n, name):
    if v is None:
        raise ValueError(f"{name} is required for this out_kind")
    t = torch.as_tensor(v, dtype=dtype, device=device)
    if t.shape != (n,):
        raise ValueError(f"{name} needs shape ({n},), got {tuple(t.shape)}")
    return t.contiguous()


def _epilogue(accum, mul, bias, thresholds, clamp_min, clamp_max, out_kind):
    """The output transform on int32 accumulators (M, N)."""
    if out_kind == "accum":
        return accum
    if out_kind == "bitpacked":
        return bitpack(accum > thresholds)
    x = torch.clamp(accum * 2, clamp_min, clamp_max).to(torch.float32)
    y = x * mul + bias  # two eager ops: two roundings, no FMA
    if out_kind == "float":
        return y
    r = torch.where(y >= 0, torch.floor(y + 0.5), torch.ceil(y - 0.5))
    return torch.clamp(r, -128, 127).to(torch.int8)


def bgemm_plain(lhs, rhs, multiplier=None, bias=None, thresholds=None, *,
                clamp_min: int = CLAMP_MIN_DEFAULT,
                clamp_max: int = CLAMP_MAX_DEFAULT, out_kind: str = "float",
                _debug_total_bits=None):
    """Plain PyTorch version of ``bgemm``.

    Unpacks both operands to +-1 float32 and multiplies them: every partial
    sum is an integer of magnitude at most 32*KW < 2**24, exact in float32
    in any order, and +-1 is exact in TF32 too. Then
    ``accum = (32*KW - t) / 2`` and the epilogue of ``out_kind``.

    Inside ``kernels.debug_checks()`` it holds the kernel's invariants:
    ``|t| <= total_bits`` (named as split-K's where the kernel splits K at
    its default depth; ``_debug_total_bits`` declares a wrong one, as the
    kernel's does) and no bit at or beyond N in a bitpacked word
    (``check_padding_bits``).
    """
    debug.require_enabled(_debug_total_bits=_debug_total_bits)
    m, kw = lhs.shape
    n = rhs.shape[1]
    a = bitunpack(lhs, BITWIDTH * kw, dtype=torch.float32)
    b = bitunpack(rhs.t(), BITWIDTH * kw, dtype=torch.float32)  # (N, 32KW)
    t = (a @ b.t()).to(torch.int32)
    if debug.enabled() and bool(
            (t.abs() > (_debug_total_bits or BITWIDTH * kw)).any()):
        debug.raise_for(2 if uses_split_k(kw) else 1)
    accum = (BITWIDTH * kw - t) // 2
    mul, bias_, thr = _operands(multiplier, bias, thresholds, n, lhs.device,
                                out_kind)
    out = _epilogue(accum, mul, bias_, thr, clamp_min, clamp_max, out_kind)
    if out_kind == "bitpacked":
        check_padding_bits(out, n)
    return out


def check_padding_bits(words, n: int) -> None:
    """Inside ``kernels.debug_checks()``: raise if a bitpacked (M, ceil(N/32))
    output has a bit set at or beyond channel ``n`` of its last word."""
    if (debug.enabled() and n % BITWIDTH
            and bool((words[:, -1] >> (n % BITWIDTH)).any())):
        debug.raise_for(4)


def _operands(multiplier, bias, thresholds, n, device, out_kind):
    if out_kind in ("float", "int8"):
        return (_vector(multiplier, torch.float32, device, n, "multiplier"),
                _vector(bias, torch.float32, device, n, "bias"), None)
    if out_kind == "bitpacked":
        return None, None, _vector(thresholds, torch.int32, device, n,
                                   "thresholds")
    return None, None, None


def plan_bgemm(m: int, n: int, kw: int, block_kw: int) -> dict:
    """Launch plan of the kernel: output tile (128 x 64, or 64 x 32 where
    the larger one would start fewer blocks than the card has SMs), grid
    (M tiles, N tiles, blocks of K) and shared-memory bytes. The wrapper
    passes the plan to the kernel's entry, which refuses one that is not
    what its tile needs."""
    num_k = ceil_div(kw, block_kw)

    def grid(bm, bn):
        return (ceil_div(m, bm), ceil_div(n, bn), num_k)

    tile = (128, 64)
    if math.prod(grid(*tile)) < SM_COUNT:
        tile = (64, 32)
    bm, bn = tile
    stage = bm * _ROW_STRIDE + max(bn * _ROW_STRIDE,
                                   _STAGE_KW * (bn + _COLUMN_PAD))
    return {"tile": tile, "grid": grid(bm, bn),
            "blocks": math.prod(grid(bm, bn)),
            "smem_bytes": 4 * _STAGES * stage}


def _library(debug_build=False):
    from ._build import load

    lib = load("bgemm", debug_build)
    fn = lib.ce_bgemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(lhs, rhs, multiplier, bias, thresholds, clamp_min, clamp_max,
            out_kind, max_block_kw, debug_total_bits=None, debug_vote_n=None):
    if lhs.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, not "
                         f"{lhs.device}")
    m, kw = lhs.shape
    n = rhs.shape[1]
    if rhs.device != lhs.device:
        raise ValueError(f"rhs is on {rhs.device}, lhs on {lhs.device}")
    if not lhs.is_contiguous():
        raise ValueError("lhs must be contiguous")
    if rhs.is_contiguous():
        b, b_n_major = rhs, 0
    elif rhs.t().is_contiguous():
        b, b_n_major = rhs.t(), 1  # the (N, KW) filter itself
    else:
        raise ValueError("rhs must be a contiguous (KW, N) tensor or the "
                         "transposed view of a contiguous (N, KW) one")
    if max(m, n, kw) >= 2 ** 31 or m * max(n, kw) >= 2 ** 31:
        raise ValueError(f"bgemm shape {(m, kw, n)} exceeds int32 indexing")
    mul, bias_, thr = _operands(multiplier, bias, thresholds, n, lhs.device,
                                out_kind)
    cols = ceil_div(n, BITWIDTH) if out_kind == "bitpacked" else n
    out = torch.empty((m, cols), dtype=_OUT_DTYPES[out_kind],
                      device=lhs.device)
    block_kw = max_block_kw if uses_split_k(kw, max_block_kw) else kw
    num_k = ceil_div(kw, block_kw)
    plan = plan_bgemm(m, n, kw, block_kw)
    if plan["grid"][2] > 65535 or math.prod(plan["grid"][:2]) >= 2 ** 31:
        raise ValueError(f"bgemm shape {(m, kw, n)} with blocks of "
                         f"{block_kw} words exceeds the grid: {plan}")
    partial = (torch.empty((num_k, m, n), dtype=torch.int32,
                           device=lhs.device) if num_k > 1 else None)
    checked = debug.enabled()
    lib = _library(checked)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The launch goes to the operands' card, whichever is current.
    with torch.cuda.device(lhs.device):
        if checked:
            debug.begin(lib, stream, debug_total_bits, debug_vote_n)
        rc = lib.ce_bgemm(
            lhs.data_ptr(), b.data_ptr(), ptr(mul), ptr(bias_), ptr(thr),
            out.data_ptr(), ptr(partial), m, n, kw, block_kw, b_n_major,
            int(plan["tile"] == (64, 32)), plan["blocks"],
            plan["smem_bytes"], _KIND_CODES[out_kind], int(clamp_min),
            int(clamp_max), stream)
        if rc != 0:
            raise RuntimeError("bgemm kernel launch failed: "
                               + lib.ce_error_string(rc).decode())
        counts.count(bgemm, ("splitk_launches"
                             if uses_split_k(kw, max_block_kw)
                             else "launches"))
        if checked:
            debug.end(lib, stream)
    return out


def bgemm(lhs, rhs, multiplier=None, bias=None, thresholds=None, *,
          clamp_min: int = CLAMP_MIN_DEFAULT,
          clamp_max: int = CLAMP_MAX_DEFAULT, out_kind: str = "float",
          max_block_kw: int = MAX_BLOCK_KW, _debug_total_bits=None,
          _debug_vote_n=None):
    """Binary GEMM on packed words with the fused output transform.

    Args:
      lhs: (M, KW) int32 words.
      rhs: (KW, N) int32 words.
      multiplier, bias: (N,) float32, for out_kind "float" and "int8".
      thresholds: (N,) int32, for out_kind "bitpacked".
      out_kind: "float" | "int8" | "accum" | "bitpacked".
      max_block_kw: the deepest K, in words, that one block sums in one
        pass; deeper GEMMs are split across blocks (the ``_bgemm_kernel_bigk``
        counterpart). The result does not depend on it.

    Returns (M, N) float32 / int8 / int32, or (M, ceil(N/32)) int32 words.
    CPU tensors take ``bgemm_plain``. CUDA tensors take the kernel, which
    counts its one-pass launches in ``bgemm.launches`` and its split-K
    launches in ``bgemm.splitk_launches`` (under a graph's capture, once
    per replay: ``kernels.counts``); inside ``kernels.debug_checks()``
    its debug build, which raises ``RuntimeError`` for a broken invariant.
    ``_debug_total_bits`` (a declared bit count) and ``_debug_vote_n`` (the
    kernel votes past N) break the accounting on purpose there.
    """
    if out_kind not in OUT_KINDS:
        raise ValueError(f"unknown out_kind {out_kind!r}; expected one of "
                         f"{OUT_KINDS}")
    if lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[1] != rhs.shape[0]:
        raise ValueError(f"bgemm operands {tuple(lhs.shape)} and "
                         f"{tuple(rhs.shape)} are not (M, KW) and (KW, N)")
    if lhs.dtype != PACKED_DTYPE or rhs.dtype != PACKED_DTYPE:
        raise TypeError("bgemm operands must be int32 packed words")
    if max_block_kw < 1:
        raise ValueError("max_block_kw must be positive")
    debug.require_enabled(_debug_total_bits=_debug_total_bits,
                          _debug_vote_n=_debug_vote_n)
    if lhs.device.type == "cpu":
        if _debug_vote_n is not None:
            raise ValueError("_debug_vote_n breaks the kernel's vote loop; "
                             "the plain version has none to break")
        return bgemm_plain(lhs, rhs, multiplier, bias, thresholds,
                           clamp_min=clamp_min, clamp_max=clamp_max,
                           out_kind=out_kind,
                           _debug_total_bits=_debug_total_bits)
    if lhs.device.type != "cuda":
        raise ValueError(f"no bgemm kernel for device {lhs.device}")
    return _launch(lhs, rhs, multiplier, bias, thresholds, clamp_min,
                   clamp_max, out_kind, max_block_kw, _debug_total_bits,
                   _debug_vote_n)


bgemm.launches = 0
bgemm.splitk_launches = 0
