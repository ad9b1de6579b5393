"""Packed-word reference binary convolution: the port's semantic oracle.

Counterpart of ``compute_engine_tpu.core.reference`` (LCE
``core/bconv2d/reference.h:35-148``): a plain implementation on packed int32
words that every faster path must match bit for bit. It materialises large
intermediates and is not a production path.

Zero padding (SAME with ``pad_value=0``) is exact for every output kind
through an integer accumulator correction:

    accum_zero_pad = accum_one_pad + sum over outside taps of
                     (binary_zero_point - popcount(filter tap))

since an out-of-image tap contributes ``binary_zero_point`` under zero
padding and ``popcount(0 ^ filter word)`` under one padding. The term of one
(output channel, tap) is ``zero_padding_tap_delta``; it depends on the filter
alone, so the model runtime computes it once per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import BConv2DParams
from .transforms import (OutputTransform, apply_output_transform_bitpacked,
                         apply_output_transform_float,
                         apply_output_transform_int8)
from .types import Padding, popcount, xor_popcount

__all__ = ["bconv2d_reference", "extract_packed_patches",
           "zero_padding_accum_correction", "zero_padding_tap_delta",
           "outside_tap_mask",
           "outside_tap_mask_t", "apply_output_kind"]


def extract_packed_patches(x, filter_h, filter_w, stride, dilation,
                           pad_top, pad_left, out_h, out_w):
    """im2col on packed words: (N, H, W, Cp) -> (N, OH, OW, FH, FW, Cp).

    Out-of-image taps read word 0 (every value +1), the one-padded im2col of
    LCE ``core/bconv2d/optimized_bgemm.h:30-31``.
    """
    sh, sw = stride
    dh, dw = dilation
    need_h = (out_h - 1) * sh + (filter_h - 1) * dh + 1
    need_w = (out_w - 1) * sw + (filter_w - 1) * dw + 1
    pad_bottom = max(0, need_h - (x.shape[1] + pad_top))
    pad_right = max(0, need_w - (x.shape[2] + pad_left))
    xp = torch.nn.functional.pad(
        x, (0, 0, pad_left, pad_right, pad_top, pad_bottom))
    taps = [xp[:, fy * dh:fy * dh + (out_h - 1) * sh + 1:sh,
               fx * dw:fx * dw + (out_w - 1) * sw + 1:sw, :]
            for fy in range(filter_h) for fx in range(filter_w)]
    patches = torch.stack(taps, dim=3)  # (N, OH, OW, FH*FW, Cp)
    return patches.reshape(*patches.shape[:3], filter_h, filter_w, -1)


def outside_tap_mask(in_h, in_w, out_h, out_w, filter_h, filter_w, stride,
                     dilation, pad_top, pad_left) -> np.ndarray:
    """Static bool mask [OH, OW, FH, FW]: the tap reads outside the image."""
    oy = np.arange(out_h)[:, None, None, None]
    ox = np.arange(out_w)[None, :, None, None]
    fy = np.arange(filter_h)[None, None, :, None]
    fx = np.arange(filter_w)[None, None, None, :]
    in_y = oy * stride[0] - pad_top + fy * dilation[0]
    in_x = ox * stride[1] - pad_left + fx * dilation[1]
    return ~((in_y >= 0) & (in_y < in_h) & (in_x >= 0) & (in_x < in_w))


def outside_tap_mask_t(in_h, in_w, out_h, out_w, filter_h, filter_w, stride,
                       dilation, pad_top, pad_left, device) -> torch.Tensor:
    """``outside_tap_mask`` computed on ``device`` (no copy from the host,
    so a CUDA graph can capture it)."""
    def ar(n):
        return torch.arange(n, device=device)

    in_y = (ar(out_h)[:, None, None, None] * stride[0] - pad_top
            + ar(filter_h)[None, None, :, None] * dilation[0])
    in_x = (ar(out_w)[None, :, None, None] * stride[1] - pad_left
            + ar(filter_w)[None, None, None, :] * dilation[1])
    return ~((in_y >= 0) & (in_y < in_h) & (in_x >= 0) & (in_x < in_w))


def zero_padding_tap_delta(packed_filter, params: BConv2DParams):
    """(O, FH * FW) int32: ``binary_zero_point - popcount(filter tap)``, what
    one out-of-image tap adds to an output channel's accumulator under zero
    padding, taps in row-major order.

    Args:
      packed_filter: (O, FH, FW, Cpg) int32 words.
    """
    tap_pop = popcount(packed_filter).sum(dim=-1, dtype=torch.int32)
    delta = params.binary_zero_point - tap_pop
    return delta.reshape(delta.shape[0], -1)


def zero_padding_accum_correction(packed_filter, params: BConv2DParams,
                                  mask):
    """Integer accumulator correction for SAME zero padding.

    Args:
      packed_filter: (O, FH, FW, Cpg) int32 words.
      mask: bool [OH, OW, FH, FW] from :func:`outside_tap_mask` (numpy) or
        :func:`outside_tap_mask_t` (a tensor).

    Returns int32 [OH, OW, O]: the sum over outside taps of
    ``binary_zero_point - popcount(filter tap)``.
    """
    delta = zero_padding_tap_delta(packed_filter, params).reshape(
        packed_filter.shape[:3])
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.asarray(mask))
    m = mask.to(device=packed_filter.device, dtype=torch.int64)
    # Integer contraction (einsum has no integer kernel on the card).
    corr = (m[:, :, None, :, :] * delta[None, None].to(torch.int64)).sum(
        dim=(3, 4))
    return corr.to(torch.int32)


def apply_output_kind(accum, transform: OutputTransform, output_kind: str):
    """The output transform of ``output_kind`` on int32 accumulators."""
    if output_kind == "float":
        return apply_output_transform_float(accum, transform)
    if output_kind == "int8":
        return apply_output_transform_int8(accum, transform)
    if output_kind == "bitpacked":
        return apply_output_transform_bitpacked(accum, transform)
    raise ValueError(f"unknown output_kind: {output_kind}")


def bconv2d_reference(packed_input, packed_filter, transform: OutputTransform,
                      params: BConv2DParams, output_kind: str = "float"):
    """Binary 2D convolution on packed words (the semantic oracle).

    Args:
      packed_input: (N, H, W, Cp) int32 words, Cp = ceil(channels_in / 32).
      packed_filter: (O, FH, FW, Cpg) int32 words, Cpg the packed depth of
        one group.
      transform: fused output transform (mul/bias or thresholds).
      output_kind: "float" | "int8" | "bitpacked".

    Returns (N, OH, OW, O) float32/int8, or (N, OH, OW, ceil(O/32)) int32
    words for bitpacked output.
    """
    n, in_h, in_w, cp = packed_input.shape
    c_out, filter_h, filter_w, cpg = packed_filter.shape
    groups = params.groups
    if cp != groups * cpg:
        raise ValueError(
            f"packed input depth {cp} != groups {groups} * packed filter depth"
            f" {cpg}")
    if c_out % groups:
        raise ValueError("channels_out must be divisible by groups")
    out_h, out_w, pad_top, pad_left = params.output_spatial(
        in_h, in_w, filter_h, filter_w)
    patches = extract_packed_patches(
        packed_input, filter_h, filter_w, params.stride, params.dilation,
        pad_top, pad_left, out_h, out_w)

    o_per_g = c_out // groups
    patches = patches.reshape(n, out_h, out_w, filter_h, filter_w, groups, cpg)
    filt = packed_filter.reshape(groups, o_per_g, filter_h, filter_w, cpg)
    accum = torch.zeros((n, out_h, out_w, groups, o_per_g), dtype=torch.int32,
                        device=packed_input.device)
    for fy in range(filter_h):
        for fx in range(filter_w):
            # (N, OH, OW, G, 1, Cpg) ^ (G, Opg, Cpg) -> popcount-sum over Cpg
            p = patches[:, :, :, fy, fx, :, None, :]
            f = filt[:, :, fy, fx, :]
            accum = accum + xor_popcount(p, f).sum(dim=-1, dtype=torch.int32)
    accum = accum.reshape(n, out_h, out_w, c_out)

    if params.padding == Padding.SAME and params.pad_value == 0:
        mask = outside_tap_mask(in_h, in_w, out_h, out_w, filter_h, filter_w,
                                params.stride, params.dilation, pad_top,
                                pad_left)
        # Each output channel sees only its own group's taps, so the
        # correction broadcasts over the full channel axis.
        accum = accum + zero_padding_accum_correction(
            packed_filter, params, mask)[None]
    return apply_output_kind(accum, transform, output_kind)
