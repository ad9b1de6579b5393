"""Quantize / Dequantize boundary ops: dense <-> bitpacked.

Counterpart of the ``LceQuantize`` / ``LceDequantize`` ops (LCE
``tflite/kernels/quantization.cc``): quantize packs float, int8 or bool to
int32 words; dequantize unpacks to +-1 float, to int8
``zero_point -+ round(1/scale)`` saturated to int8
(``quantization.cc:130-138``), or to bool.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitpack import bitpack, bitunpack

__all__ = ["quantize", "dequantize"]


def quantize(x: torch.Tensor, zero_point: int = 0) -> torch.Tensor:
    """Pack the channel (last) axis to int32 words.

    float: bit = x < 0; int8: bit = x < zero_point; bool: bit = x
    (``quantization.cc:76-108``).
    """
    return bitpack(x, zero_point=zero_point)


def dequantize(packed: torch.Tensor, channels: int, dtype=torch.float32,
               scale: float | None = None, zero_point: int = 0):
    """Unpack words to +-1 values.

    For int8 output the +-1 is expressed in the quantised domain:
    ``zero_point -+ round(1/scale)`` saturated to int8.
    """
    if dtype == torch.int8:
        if scale is None:
            raise ValueError("int8 dequantize requires a scale")
        step = int(np.round(1.0 / scale))
        one = int(np.clip(zero_point + step, -128, 127))
        minus_one = int(np.clip(zero_point - step, -128, 127))
        return bitunpack(packed, channels, zero_bit_result=one,
                         one_bit_result=minus_one, dtype=torch.int8)
    return bitunpack(packed, channels, dtype=dtype)
