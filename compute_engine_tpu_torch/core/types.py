"""Core type and constant definitions of the PyTorch port.

Same semantic contract as ``compute_engine_tpu.core.types`` (LCE's
``core/types.h``), with one difference of representation: packed words are
held as ``int32`` tensors. Only bitwise operations are applied to them, so
signedness does not matter, and torch has no right shift for ``uint32`` on the
CPU. Artifacts keep ``uint32`` on disk; ``interop.layers_from_numpy`` views
them as ``int32``.
"""

from __future__ import annotations

import enum

import torch

# Number of values packed into one word (LCE `core/types.h:41`).
BITWIDTH = 32

# Packed-word dtype of the port's tensors.
PACKED_DTYPE = torch.int32


class Padding(enum.Enum):
    """Convolution padding mode; ``pad_value`` on the op picks one- or
    zero-padding for SAME."""

    VALID = "VALID"
    SAME = "SAME"


class Activation(enum.Enum):
    """Fused activation in the conceptual (-K..K) output domain."""

    NONE = "NONE"
    RELU = "RELU"
    RELU_N1_TO_1 = "RELU_N1_TO_1"
    RELU6 = "RELU6"


def saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """Clamp an integer tensor to the int8 range and cast."""
    return torch.clamp(x, -128, 127).to(torch.int8)


def round_half_away(y: torch.Tensor) -> torch.Tensor:
    """Round to nearest with ties away from zero (C++ ``std::round``).

    ``torch.round`` rounds half to even, which differs on exact ties.
    """
    return torch.where(y >= 0, torch.floor(y + 0.5), torch.ceil(y - 0.5))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each int32 word, as int32.

    torch has no ``bitwise_count``, so this is the SWAR form, taken on the
    two 16-bit halves of the word: every intermediate stays non-negative
    and below 2**16, so no signed int32 arithmetic overflows.
    """
    x = x.to(torch.int32)
    total = None
    for half in (x & 0xFFFF, (x >> 16) & 0xFFFF):
        v = half - ((half >> 1) & 0x5555)
        v = (v & 0x3333) + ((v >> 2) & 0x3333)
        v = (v + (v >> 4)) & 0x0F0F
        v = (v + (v >> 8)) & 0x1F
        total = v if total is None else total + v
    return total


def xor_popcount(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of bits that differ between packed words ``a`` and ``b``
    (LCE ``core/types.h:45-48``), as int32."""
    return popcount(torch.bitwise_xor(a, b))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def packed_size(channels: int) -> int:
    """Number of packed words needed for ``channels`` values."""
    return ceil_div(channels, BITWIDTH)
