"""Static configuration of binary convolutions (LCE ``BConv2DParams``)."""

from __future__ import annotations

import dataclasses

from .types import Activation, Padding, ceil_div


def tflite_same_padding(in_size: int, filter_size: int, stride: int,
                        dilation: int):
    """TF/TFLite SAME padding: (out_size, pad_before, pad_after)."""
    eff = (filter_size - 1) * dilation + 1
    out = ceil_div(in_size, stride)
    total = max((out - 1) * stride + eff - in_size, 0)
    return out, total // 2, total - total // 2


def valid_padding_out(in_size: int, filter_size: int, stride: int,
                      dilation: int) -> int:
    eff = (filter_size - 1) * dilation + 1
    return (in_size - eff) // stride + 1


@dataclasses.dataclass(frozen=True)
class BConv2DParams:
    """Static parameters of a binary 2D convolution.

    ``channels_in`` is the number of unpacked input channels; ``pad_value``
    in {0, 1} selects zero- or one-padding for SAME padding.
    """

    channels_in: int
    stride: tuple[int, int] = (1, 1)
    dilation: tuple[int, int] = (1, 1)
    padding: Padding = Padding.VALID
    pad_value: int = 1
    groups: int = 1
    activation: Activation = Activation.NONE

    def __post_init__(self):
        if self.pad_value not in (0, 1):
            raise ValueError("pad_value must be 0 or 1")
        if self.channels_in % self.groups != 0:
            raise ValueError("channels_in must be divisible by groups")

    @property
    def channels_in_per_group(self) -> int:
        return self.channels_in // self.groups

    @property
    def binary_zero_point(self) -> int:
        """Accumulator contribution of one out-of-image tap under
        zero-padding."""
        return self.channels_in_per_group // 2

    def backtransform_add(self, filter_height: int, filter_width: int) -> int:
        """K = FH * FW * C_in_per_group."""
        return filter_height * filter_width * self.channels_in_per_group

    def output_spatial(self, in_h: int, in_w: int, filter_h: int,
                       filter_w: int):
        """(out_h, out_w, pad_top, pad_left) for this padding mode."""
        if self.padding == Padding.SAME:
            oh, pt, _ = tflite_same_padding(in_h, filter_h, self.stride[0],
                                            self.dilation[0])
            ow, pl, _ = tflite_same_padding(in_w, filter_w, self.stride[1],
                                            self.dilation[1])
            return oh, ow, pt, pl
        oh = valid_padding_out(in_h, filter_h, self.stride[0], self.dilation[0])
        ow = valid_padding_out(in_w, filter_w, self.stride[1], self.dilation[1])
        return oh, ow, 0, 0
