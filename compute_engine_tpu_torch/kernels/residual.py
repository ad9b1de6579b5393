"""Fused binary residual block: sign + 3x3 SAME bconv + transform + add.

``binary_residual_block`` is the port of the Pallas kernel
``compute_engine_tpu.kernels.residual._block_kernel``: on a CUDA tensor it
launches the hand-written kernel in ``csrc/residual_block.cu``; on a CPU
tensor it runs ``binary_residual_block_plain``, the plain PyTorch version of
the same function. With ``has_residual=False`` it is the same conv without
the add, for a conv whose consumer is not its residual add.

The kernel is an implicit GEMM on the tensor cores (single-bit
``mma.sync``, AND + popcount): it signs the activation band into packed words
in shared memory and reads the packed filter as it is, so no prepared layout
is needed. ``plan_residual_block`` is the launch plan (block size, grid,
shared memory) in Python, where the CPU tests can check it; every shape
``residual_block_supported`` accepts takes this kernel.

Padding: the band pads with +1 (0 bits), the one-padding. A zero-padded
conv (``pad_value=0``, Bi-RealNet's) runs the same band and products and
adds, in the epilogue, what zero padding changes: for each tap outside the
image, ``delta[co][tap] = binary_zero_point - popcount(filter tap)``
(``core.reference.zero_padding_tap_delta``), an (O, 9) int32 table that
depends on the filter alone. The model runtime computes it once per layer
(``models.prepare_runtime_arrays``, ``tap_delta``) and passes it in; a call
without it computes it on the spot. Zero-padded launches are also counted
in ``binary_residual_block.zero_pad_launches``.

Rounding: the conv result is an exact integer on both paths. The epilogue
computes ``clip(2*acc) * mul`` and then ``+ bias`` as two roundings (no FMA),
rounds to the activation type, and adds ``x`` with one more rounding, as the
unfused "store, then add" chain does. The kernel therefore equals the plain
version bit for bit; against JAX it may differ by one FMA rounding, as
JAX's own fused and unfused paths do.

Inside ``kernels.debug_checks()`` the kernel's debug build runs, and the
plain version checks, the Pallas kernel's debug invariant ``|t| <= K``
(K = 9 C) for the +-1 conv ``t`` (``kernels/debug.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.params import BConv2DParams
from ..core.reference import zero_padding_tap_delta
from ..core.transforms import OutputTransform
from ..core.types import Padding
from . import counts, debug
from .bconv2d import bconv2d_mxu_float_in

__all__ = ["binary_residual_block", "binary_residual_block_plain",
           "residual_block_supported", "plan_residual_block"]

SM_COUNT = 132                 # H100 SXM
MAX_SHARED_BYTES = 232_448     # 227 KB a block may use
_BLOCK_CHANNELS = 64           # output channels per block
_WARP_POSITIONS = 32           # output positions per warp
_STAGE_STRIDE = _BLOCK_CHANNELS + 8
# Zero padding: a correction table of 16 tap patterns and the tile's (64, 9)
# delta rows, in 32-bit words.
_ZERO_PAD_WORDS = 16 * _BLOCK_CHANNELS + 9 * _BLOCK_CHANNELS

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def residual_block_supported(x_shape, params: BConv2DParams, c_out: int,
                             fh: int, fw: int, has_residual: bool = True
                             ) -> bool:
    """Static conditions under which the fused kernel applies: a 3x3,
    stride-1, undilated, ungrouped conv with SAME padding (one or zero), and
    as many output channels as input channels when the residual is
    added."""
    c = x_shape[-1]
    if (fh, fw) != (3, 3) or (has_residual and c != c_out):
        return False
    return (params.groups == 1 and params.stride == (1, 1)
            and params.dilation == (1, 1)
            and params.padding == Padding.SAME)


def binary_residual_block_plain(x, packed_filter, transform: OutputTransform,
                                params: BConv2DParams, has_residual=True,
                                unpacked_filter=None, tap_delta=None,
                                _debug_k=None):
    """Plain PyTorch version: the unfused conv, rounded to ``x.dtype``, plus
    ``x``; zero padding is the integer conv's own (``tap_delta`` is not
    read). Inside ``kernels.debug_checks()`` it also holds ``|t| <= K``
    (``_debug_k`` declares a K other than 9 C, as the kernel's does)."""
    debug.require_enabled(_debug_k=_debug_k)
    if debug.enabled():
        _check_conv_bound(x, packed_filter, params, unpacked_filter, _debug_k)
    y = bconv2d_mxu_float_in(x, packed_filter, transform, params,
                             output_kind="float",
                             unpacked_filter=unpacked_filter).to(x.dtype)
    return x + y if has_residual else y


def _check_conv_bound(x, packed_filter, params, unpacked_filter, declared_k):
    """``|t| <= K`` for the +-1 conv ``t``: through the identity transform
    the float output is ``2 accum = 9 C - t``, exact in float32."""
    c_out = packed_filter.shape[0]
    identity = OutputTransform(
        multiplier=torch.ones(c_out, dtype=torch.float32, device=x.device),
        bias=torch.zeros(c_out, dtype=torch.float32, device=x.device))
    two_accum = bconv2d_mxu_float_in(x, packed_filter, identity, params,
                                     output_kind="float",
                                     unpacked_filter=unpacked_filter)
    k = 9 * x.shape[-1]
    t = k - two_accum
    if bool((t.abs() > (declared_k or k)).any()):
        debug.raise_for(8)


def plan_residual_block(n: int, h: int, w: int, c: int, c_out: int,
                        itemsize: int = 2, warps: int | None = None,
                        tiles_per_block: int | None = None,
                        zero_pad: bool = False) -> dict:
    """Launch plan of the kernel for an (n, h, w, c) input of ``itemsize``
    bytes an element. The wrapper passes the plan to the kernel's entry,
    which refuses one that is not what its shared-memory layout needs.

    A block takes ``32 * warps`` consecutive positions of the flat padded
    index ``n * (h + 2) * (w + 2)``, signs their band once and computes
    ``tiles_per_block`` tiles of 64 output channels from it. Unless given,
    both are chosen by ``_choose_blocks``, alike for both paddings; the
    zero-padded form's shared memory holds its correction tables besides.
    """
    cw = -(-c // 32)
    kw_pad = -(-9 * cw // 8) * 8
    positions = n * (h + 2) * (w + 2)
    n_tiles = -(-c_out // _BLOCK_CHANNELS)
    if warps is None or tiles_per_block is None:
        warps, tiles_per_block = _choose_blocks(positions, n_tiles)
    bm = _WARP_POSITIONS * warps
    band = bm + 2 * (w + 2) + 2
    grid = (-(-positions // bm), -(-n_tiles // tiles_per_block))
    words = (_BLOCK_CHANNELS * (kw_pad + 4)
             + band * (cw + 4 if cw % 8 == 0 else cw)
             + kw_pad + _BLOCK_CHANNELS + band
             + (_ZERO_PAD_WORDS if zero_pad else 0))
    return {"warps": warps, "tiles_per_block": tiles_per_block,
            "grid": grid, "blocks": grid[0] * grid[1],
            "smem_bytes": 4 * words + itemsize * bm * _STAGE_STRIDE}


def _choose_blocks(positions: int, n_tiles: int) -> tuple[int, int]:
    """(warps, tiles_per_block). Two channel tiles per band where there are
    two: measured on an H100 (``chip_smoke.py --sweep-residual``), two beat
    one at every QuickNet section and four lose more in blocks than they
    save in signing. Then eight warps where that nearly fills the two 8-warp
    blocks an SM holds, else four where every SM still gets a block, else
    two."""
    tiles_per_block = min(2, n_tiles)
    groups = -(-n_tiles // tiles_per_block)

    def blocks(warps):
        return -(-positions // (_WARP_POSITIONS * warps)) * groups

    if blocks(8) >= 0.9 * 2 * SM_COUNT:
        return 8, tiles_per_block
    return (4 if blocks(4) >= SM_COUNT else 2), tiles_per_block


def _library(debug_build=False):
    from ._build import load

    lib = load("residual_block", debug_build)
    fn = lib.ce_residual_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, packed_filter, transform, has_residual, block=None,
            debug_k=None, tap_delta=None):
    """Launches the kernel, zero-padded where ``tap_delta`` (the (C_out, 9)
    int32 table) is given. ``block`` is (warps, tiles_per_block) in place
    of the planner's choice, for a sweep over block sizes; ``debug_k`` is
    the K that the debug build holds ``|t|`` to (9 C by default)."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, not {x.device}")
    n, h, w, c = x.shape
    c_out = packed_filter.shape[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"residual block kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if packed_filter.shape[1:] != (3, 3, -(-c // 32)):
        raise ValueError(f"packed filter {tuple(packed_filter.shape)} does "
                         f"not match {c} input channels")
    if packed_filter.dtype != torch.int32:
        raise TypeError("packed filter words must be int32")
    mul = torch.as_tensor(transform.multiplier, dtype=torch.float32,
                          device=x.device)
    bias = torch.as_tensor(transform.bias, dtype=torch.float32,
                           device=x.device)
    operands = [("x", x), ("packed_filter", packed_filter), ("mul", mul),
                ("bias", bias)]
    zero_pad = tap_delta is not None
    if zero_pad:
        if tap_delta.shape != (c_out, 9) or tap_delta.dtype != torch.int32:
            raise ValueError(f"tap_delta must be ({c_out}, 9) int32, not "
                             f"{tuple(tap_delta.shape)} {tap_delta.dtype}")
        operands.append(("tap_delta", tap_delta))
    for name, t in operands:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mul.shape != (c_out,) or bias.shape != (c_out,):
        raise ValueError("multiplier and bias need one value per channel")
    plan = plan_residual_block(n, h, w, c, c_out, x.element_size(),
                               *(block or ()), zero_pad=zero_pad)
    if plan["smem_bytes"] > MAX_SHARED_BYTES or plan["blocks"] >= 2 ** 31:
        raise ValueError(f"residual block {tuple(x.shape)} -> {c_out} "
                         f"channels does not fit the kernel: {plan}")
    out = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    checked = debug.enabled()
    lib = _library(checked)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # The launch goes to the activation's card, whichever is current.
    with torch.cuda.device(x.device):
        if checked:
            debug.begin(lib, stream, declared_bits=debug_k)
        rc = lib.ce_residual_block(
            x.data_ptr(), packed_filter.data_ptr(), mul.data_ptr(),
            bias.data_ptr(), tap_delta.data_ptr() if zero_pad else None,
            out.data_ptr(), n, h, w, c, c_out,
            int(transform.clamp_min), int(transform.clamp_max),
            int(has_residual), _DTYPE_CODES[x.dtype], plan["warps"],
            plan["tiles_per_block"], plan["blocks"], plan["smem_bytes"],
            stream)
        if rc != 0:
            raise RuntimeError("residual block kernel launch failed: "
                               + lib.ce_error_string(rc).decode())
        _count_launch(zero_pad)
        if checked:
            debug.end(lib, stream)
    return out


def _count_launch(zero_pad: bool) -> None:
    """One launch of the kernel in ``binary_residual_block.launches``, and in
    ``zero_pad_launches`` too where it is zero-padded (``kernels.counts``)."""
    counts.count(binary_residual_block)
    if zero_pad:
        counts.count(binary_residual_block, "zero_pad_launches")


def binary_residual_block(x, packed_filter, transform: OutputTransform,
                          params: BConv2DParams, has_residual=True,
                          unpacked_filter=None, tap_delta=None,
                          _debug_k=None):
    """``x + float_transform(bconv3x3_same(sign(x)))`` in one kernel.

    Args:
      x: (N, H, W, C) float32 or bfloat16 activations.
      packed_filter: (C_out, 3, 3, ceil(C/32)) int32 packed filter.
      transform: float OutputTransform (multiplier, bias, clamps).
      params: stride-1 SAME BConv2DParams, one or zero padding, groups=1.
      has_residual: add ``x`` (needs C_out == C); False returns the conv.
      unpacked_filter: (3, 3, C, C_out) +-1 filter for the plain version.
      tap_delta: for zero padding, the (C_out, 9) int32
        ``zero_padding_tap_delta`` of ``packed_filter`` on the activation's
        device; computed here when not given. Not read under one padding.

    Returns (N, H, W, C_out) in ``x.dtype``. CPU tensors take the plain
    version; CUDA tensors take the kernel, which counts its launches in
    ``binary_residual_block.launches``, and the zero-padded ones also in
    ``binary_residual_block.zero_pad_launches`` (under a graph's capture,
    once per replay: ``kernels.counts``); inside ``kernels.debug_checks()``
    its debug build, which raises ``RuntimeError`` when ``|t| > K``.
    ``_debug_k`` declares a wrong K there, on purpose.
    """
    c_out, fh, fw, _ = packed_filter.shape
    if not residual_block_supported(x.shape, params, c_out, fh, fw,
                                    has_residual):
        raise ValueError("fused residual block unsupported for "
                         f"shape {tuple(x.shape)} / filter "
                         f"{tuple(packed_filter.shape)}")
    debug.require_enabled(_debug_k=_debug_k)
    if x.device.type == "cpu":
        return binary_residual_block_plain(x, packed_filter, transform,
                                           params, has_residual,
                                           unpacked_filter,
                                           _debug_k=_debug_k)
    if x.device.type != "cuda":
        raise ValueError(f"no residual block kernel for device {x.device}")
    if params.pad_value == 1:
        tap_delta = None
    elif tap_delta is None:
        tap_delta = zero_padding_tap_delta(packed_filter, params)
    return _launch(x, packed_filter, transform, has_residual,
                   debug_k=_debug_k, tap_delta=tap_delta)


binary_residual_block.launches = 0
binary_residual_block.zero_pad_launches = 0
