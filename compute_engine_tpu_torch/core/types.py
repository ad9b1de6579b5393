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


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def packed_size(channels: int) -> int:
    """Number of packed words needed for ``channels`` values."""
    return ceil_div(channels, BITWIDTH)
