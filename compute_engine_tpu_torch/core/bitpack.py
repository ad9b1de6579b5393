"""Bitpacking: dense tensors <-> packed words along the channel axis.

Contract (identical to ``compute_engine_tpu.core.bitpack`` and LCE's
``core/bitpacking/bitpack.h``):

* 32 values per word along the last axis, LSB first: bit ``j`` of word ``w``
  holds element ``32*w + j``.
* A set bit encodes a negative value, ``bit = value < zero_point`` (floats use
  zero point 0), so a set bit is -1 and a clear bit +1.
* Padding bits (``channels % 32 != 0``) are 0.
* An out-of-range integer zero point gives all-0 or all-1 bits.

``bitpack``/``bitunpack`` work on torch tensors with ``int32`` words;
``bitpack_np`` is the host copy on numpy ``uint32`` words that the converter
uses to write artifacts.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import BITWIDTH, PACKED_DTYPE, packed_size

__all__ = ["bitpack", "bitunpack", "bitpack_np", "packed_shape"]


def packed_shape(shape):
    """Shape after packing the last axis: ``(..., ceil(C/32))``."""
    return (*shape[:-1], packed_size(shape[-1]))


def _bits(x, zero_point, is_bool, is_float, iinfo):
    """``value < zero_point`` as bools, with the out-of-range fast paths
    (``bitpack.h:259-288``)."""
    if is_bool:
        return x
    if is_float:
        if zero_point != 0:
            raise ValueError("zero_point must be 0 for floating-point input")
        return x < 0
    info = iinfo(x.dtype)
    if zero_point <= info.min:
        return x < x  # all False
    if zero_point > info.max:
        return x == x  # all True
    return x < zero_point


def bitpack(x: torch.Tensor, zero_point: int = 0) -> torch.Tensor:
    """Pack the last axis of ``x`` into int32 words, 32 values per word."""
    channels = x.shape[-1]
    n_words = packed_size(channels)
    bits = _bits(x, zero_point, x.dtype == torch.bool, x.is_floating_point(),
                 torch.iinfo)
    pad = n_words * BITWIDTH - channels
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*x.shape[:-1], n_words, BITWIDTH).to(torch.int64)
    # Bit 31 has the int32 value -2**31, so the int64 sum of the set bits is
    # the word's int32 value. Made on the device (no copy from the host, so
    # a CUDA graph can capture it).
    shifts = torch.arange(BITWIDTH, dtype=torch.int64, device=x.device)
    weights = (torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
               - (shifts == BITWIDTH - 1).to(torch.int64) * (1 << 32))
    return (bits * weights).sum(-1).to(PACKED_DTYPE)


def bitpack_np(x, zero_point: int = 0) -> np.ndarray:
    """Host bitpack on numpy with the same contract; returns ``uint32``.

    float32 and int8 go through the native host library
    (``utils.native``) where a compiler built it; numpy otherwise."""
    x = np.asarray(x)
    if x.dtype in (np.float32, np.int8):
        from ..utils.native import native_bitpack

        out = native_bitpack(x, zero_point)
        if out is not None:
            return out
    channels = x.shape[-1]
    n_words = packed_size(channels)
    bits = _bits(x, zero_point, x.dtype == np.bool_,
                 np.issubdtype(x.dtype, np.floating), np.iinfo)
    pad = n_words * BITWIDTH - channels
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], pad), np.bool_)], axis=-1)
    bits = bits.reshape(*x.shape[:-1], n_words, BITWIDTH).astype(np.uint32)
    shifts = np.left_shift(np.uint32(1), np.arange(BITWIDTH, dtype=np.uint32))
    return np.bitwise_or.reduce(bits * shifts, axis=-1).astype(np.uint32)


def bitunpack(packed: torch.Tensor, channels: int, zero_bit_result=1,
              one_bit_result=-1, dtype=torch.float32) -> torch.Tensor:
    """Unpack int32 words back to ``channels`` values along the last axis.

    Set bits map to ``one_bit_result`` (-1), clear bits to
    ``zero_bit_result`` (+1); ``dtype=torch.bool`` returns the bits.
    """
    n_words = packed.shape[-1]
    if n_words != packed_size(channels):
        raise ValueError(
            f"packed last dim {n_words} does not match channels={channels}")
    shifts = torch.arange(BITWIDTH, dtype=PACKED_DTYPE, device=packed.device)
    bits = (packed.to(PACKED_DTYPE)[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], n_words * BITWIDTH)[..., :channels]
    if dtype == torch.bool:
        return bits.bool()
    one = torch.full((), one_bit_result, dtype=dtype, device=packed.device)
    zero = torch.full((), zero_bit_result, dtype=dtype, device=packed.device)
    return torch.where(bits != 0, one, zero)
