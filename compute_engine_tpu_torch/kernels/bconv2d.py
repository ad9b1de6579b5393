"""Binary 2D convolution paths of the port.

* ``bconv2d_bgemm``: conv as a GEMM on packed words, the counterpart of
  ``compute_engine_tpu.kernels.bconv2d.bconv2d_bgemm``: a packed im2col in
  torch ops (pure data movement, as XLA does it in JAX), then ``bgemm``,
  which launches the CUDA kernel on the card and its plain version on the
  CPU.
* ``bconv2d_mxu_float_in``: the plain PyTorch version of the binary conv on
  float activations (counterpart of the JAX function of that name): sign the
  activations to +-1 (``x < 0`` is -1, so sign(0) = sign(-0.0) = +1), pad,
  contract with the +-1 filter, then apply the output transform to the
  conceptual conv result ``t = K - 2 * accum``. The contraction is an im2col
  of padded slices followed by a float32 ``matmul``. Every partial sum is an
  integer below 2**24, so the result is exact in any summation order, and
  TF32 cannot round it either (+-1 and 0 are exact in TF32). ``F.conv2d`` is
  not used: cuDNN may pick a Winograd or FFT algorithm whose transforms
  round. Nor is int8: torch's CPU int8 matmul returns int8 and wraps.
"""

from __future__ import annotations

import torch

from ..core.bitpack import bitunpack
from ..core.params import BConv2DParams, tflite_same_padding
from ..core.transforms import OutputTransform
from ..core.reference import (apply_output_kind, extract_packed_patches,
                              outside_tap_mask, zero_padding_accum_correction)
from ..core.types import Padding
from .bgemm import bgemm

__all__ = ["bconv2d_bgemm", "bconv2d_mxu_float_in", "outside_tap_mask"]


def bconv2d_bgemm(packed_input, packed_filter, transform: OutputTransform,
                  params: BConv2DParams, output_kind: str = "float",
                  gemm=bgemm):
    """Packed im2col + the xor-popcount ``bgemm``.

    Same contract as ``core.reference.bconv2d_reference``. Grouped convs run
    one ``accum`` GEMM per group (grouped filters keep their per-group packed
    depth); zero padding takes ``accum`` plus the integer correction; every
    other case runs the fused epilogue of ``output_kind`` in the kernel.
    ``gemm`` may be ``bgemm_plain`` to run the plain version on the card.
    """
    n, in_h, in_w, _ = packed_input.shape
    c_out, fh, fw, cpg = packed_filter.shape
    groups = params.groups
    out_h, out_w, pad_top, pad_left = params.output_spatial(in_h, in_w, fh, fw)
    patches = extract_packed_patches(
        packed_input, fh, fw, params.stride, params.dilation, pad_top,
        pad_left, out_h, out_w)  # (N, OH, OW, FH, FW, Cp)
    m = n * out_h * out_w
    zero_pad = params.padding == Padding.SAME and params.pad_value == 0

    if groups == 1:
        lhs = patches.reshape(m, fh * fw * cpg)
        rhs = packed_filter.reshape(c_out, fh * fw * cpg).t()
        if zero_pad:
            accum = gemm(lhs, rhs, out_kind="accum")
        elif output_kind == "bitpacked":
            out = gemm(lhs, rhs, thresholds=transform.thresholds,
                        out_kind="bitpacked")
            return out.reshape(n, out_h, out_w, out.shape[-1])
        else:
            out = gemm(lhs, rhs, transform.multiplier, transform.bias,
                        clamp_min=transform.clamp_min,
                        clamp_max=transform.clamp_max, out_kind=output_kind)
            return out.reshape(n, out_h, out_w, c_out)
    else:
        o_per_g = c_out // groups
        p = patches.reshape(m, fh * fw, groups, cpg)
        filt = packed_filter.reshape(groups, o_per_g, fh * fw * cpg)
        accum = torch.cat(
            [gemm(p[:, :, g, :].reshape(m, fh * fw * cpg).contiguous(),
                   filt[g].t(), out_kind="accum") for g in range(groups)],
            dim=-1)

    accum = accum.reshape(n, out_h, out_w, c_out)
    if zero_pad:
        mask = outside_tap_mask(in_h, in_w, out_h, out_w, fh, fw,
                                params.stride, params.dilation, pad_top,
                                pad_left)
        accum = accum + zero_padding_accum_correction(
            packed_filter, params, mask)[None]
    return apply_output_kind(accum, transform, output_kind)


def _true_output_transform(true_out, transform: OutputTransform, k: int,
                           output_kind: str):
    """Apply the output transform to the conceptual +-1 conv result ``t``.

    The accumulator is ``floor((K - t) / 2)``: exact when every tap is a
    real +-1 value (``K - t`` is even), and the reference's floor for zero
    padding with odd depth.
    """
    accum = torch.div(k - true_out.to(torch.int32), 2, rounding_mode="floor")
    return apply_output_kind(accum, transform, output_kind)


def bconv2d_mxu_float_in(x: torch.Tensor, packed_filter: torch.Tensor,
                         transform: OutputTransform, params: BConv2DParams,
                         output_kind: str = "float",
                         unpacked_filter: torch.Tensor | None = None):
    """Binary conv taking float activations (NHWC).

    Args:
      x: (N, H, W, C) float activations.
      packed_filter: (O, FH, FW, ceil(C/groups/32)) int32 packed filter.
      transform: float/int8 OutputTransform, or thresholds for bitpacked.
      params: BConv2DParams (VALID, SAME one-padding or SAME zero-padding).
      output_kind: "float", "int8" or "bitpacked".
      unpacked_filter: optional (FH, FW, C/groups, O) +-1 filter, skipping
        the unpack.

    Returns (N, OH, OW, O) float32 or int8, or (N, OH, OW, ceil(O/32)) int32
    words.
    """
    n, in_h, in_w, c_in = x.shape
    c_out, fh, fw, _ = packed_filter.shape
    groups = params.groups
    cg = c_in // groups
    if c_in != params.channels_in:
        raise ValueError(f"input channels {c_in} != params.channels_in "
                         f"{params.channels_in}")
    out_h, out_w, pad_top, pad_left = params.output_spatial(in_h, in_w, fh, fw)
    k = params.backtransform_add(fh, fw)
    zero_pad = params.padding == Padding.SAME and params.pad_value == 0
    sh, sw = params.stride
    dh, dw = params.dilation

    xq = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    if params.padding == Padding.SAME:
        # Zero padding pads the literal 0, one padding the literal +1.
        _, _, pad_bottom = tflite_same_padding(in_h, fh, sh, dh)
        _, _, pad_right = tflite_same_padding(in_w, fw, sw, dw)
        xq = torch.nn.functional.pad(
            xq, (0, 0, pad_left, pad_right, pad_top, pad_bottom),
            value=0.0 if zero_pad else 1.0)
    if unpacked_filter is None:
        w = bitunpack(packed_filter, cg, dtype=torch.float32)
        w = w.permute(1, 2, 3, 0)  # (FH, FW, Cg, O)
    else:
        w = unpacked_filter.to(torch.float32)

    taps = [xq[:, fy * dh:fy * dh + (out_h - 1) * sh + 1:sh,
               fx * dw:fx * dw + (out_w - 1) * sw + 1:sw, :]
            for fy in range(fh) for fx in range(fw)]
    patches = torch.cat(taps, dim=-1)  # (N, OH, OW, FH*FW*C), (tap, c) order
    if groups == 1:
        true_out = patches @ w.reshape(fh * fw * cg, c_out)
    else:
        opg = c_out // groups
        p = patches.reshape(n, out_h, out_w, fh * fw, groups, cg)
        p = p.permute(0, 1, 2, 4, 3, 5).reshape(n, out_h, out_w, groups, 1,
                                                fh * fw * cg)
        wg = w.reshape(fh * fw, cg, groups, opg).permute(2, 0, 1, 3)
        true_out = (p @ wg.reshape(groups, fh * fw * cg, opg)).reshape(
            n, out_h, out_w, c_out)

    if zero_pad and cg % 2:
        # Reference quirk: an out-of-image tap adds floor(c/2) to the
        # accumulator, i.e. (c mod 2) to the conv result.
        mask = outside_tap_mask(in_h, in_w, out_h, out_w, fh, fw,
                                params.stride, params.dilation, pad_top,
                                pad_left)
        n_outside = torch.as_tensor(mask.sum(axis=(2, 3)),
                                    dtype=torch.float32, device=x.device)
        true_out = true_out + n_outside[None, :, :, None]

    return _true_output_transform(true_out, transform, k, output_kind)
