"""Binary max-pooling on packed words.

The max over {-1, +1} values is a bitwise AND of the packed words: a set bit
encodes -1, so the max is +1 (clear) unless every value in the window is -1.
LCE ``core/bmaxpool.h:23-88`` starts each window from all-ones and clamps it
to the image, which is an AND reduction whose padding is the identity ``~0``.
"""

from __future__ import annotations

import dataclasses

import torch

from .params import tflite_same_padding
from .types import Padding

__all__ = ["bmaxpool", "BMaxPoolParams"]


@dataclasses.dataclass(frozen=True)
class BMaxPoolParams:
    """Static pooling parameters (LCE ``core/bmaxpool.h:14-21``)."""

    filter_size: tuple[int, int]
    stride: tuple[int, int]
    padding: Padding = Padding.SAME


def bmaxpool(packed_input: torch.Tensor, params: BMaxPoolParams):
    """AND-reduce packed words over each pooling window.

    Args:
      packed_input: (N, H, W, Cp) int32 words.

    Returns (N, OH, OW, Cp) int32 words.
    """
    fh, fw = params.filter_size
    sh, sw = params.stride
    _, in_h, in_w, _ = packed_input.shape
    if params.padding == Padding.SAME:
        out_h, pt, pb = tflite_same_padding(in_h, fh, sh, 1)
        out_w, pl, pr = tflite_same_padding(in_w, fw, sw, 1)
        # ~0 (every bit set) is the identity of AND.
        x = torch.nn.functional.pad(packed_input, (0, 0, pl, pr, pt, pb),
                                    value=-1)
    else:
        out_h = (in_h - fh) // sh + 1
        out_w = (in_w - fw) // sw + 1
        x = packed_input
    out = None
    for dy in range(fh):
        for dx in range(fw):
            tap = x[:, dy:dy + (out_h - 1) * sh + 1:sh,
                    dx:dx + (out_w - 1) * sw + 1:sw, :]
            out = tap if out is None else torch.bitwise_and(out, tap)
    return out.contiguous()
