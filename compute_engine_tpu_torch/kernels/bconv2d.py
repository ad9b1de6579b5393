"""Binary 2D convolution paths of the port.

* ``bconv2d_bgemm``: conv as a GEMM on packed words, the counterpart of
  ``compute_engine_tpu.kernels.bconv2d.bconv2d_bgemm``: a packed im2col in
  torch ops (pure data movement, as XLA does it in JAX), then ``bgemm``,
  which launches the CUDA kernel on the card and its plain version on the
  CPU.
* ``bconv2d_mxu`` (packed input), ``bconv2d_mxu_float_in`` and
  ``bconv2d_mxu_s2d`` (float input): the JAX package's "mxu" and "s2d"
  lowerings, which are XLA convolutions there and no Pallas kernels. Here
  they are library lowerings, not ports of a kernel: the operands are signed
  or unpacked to +-1 int8 and contracted exactly, by an im2col and one
  integer matrix product (``models.layers.conv2d_int8``: ``torch._int_mm``,
  int8 in and int32 out, on the card; int32 on the CPU). The output
  transform is then applied to the conceptual conv result
  ``t = K - 2 * accum``. ``bconv2d_mxu_float_in`` keeps a float32 contraction
  on the CPU: every partial sum is an integer below 2**24, exact in any
  order. cuDNN is not used for any of them: its algorithm choice may round
  (Winograd, FFT), and the integer route is exact on every host.
  ``bconv2d_mxu_s2d`` retiles a 2x2 spatial cell into channels
  (space-to-depth) before the same contraction.

Signs follow ``x < 0`` -> -1, so sign(0) = sign(-0.0) = +1.
"""

from __future__ import annotations

import torch

from ..core.bitpack import bitunpack
from ..core.params import BConv2DParams, tflite_same_padding
from ..core.transforms import OutputTransform
from ..core.reference import (apply_output_kind, extract_packed_patches,
                              outside_tap_mask, outside_tap_mask_t,
                              zero_padding_accum_correction)
from ..core.types import Padding, ceil_div
from .bgemm import bgemm

__all__ = ["bconv2d_bgemm", "bconv2d_mxu", "bconv2d_mxu_float_in",
           "bconv2d_mxu_s2d", "bdense_mxu", "bdense_mxu_float_in",
           "outside_tap_mask"]


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
        mask = outside_tap_mask_t(in_h, in_w, out_h, out_w, fh, fw,
                                  params.stride, params.dilation, pad_top,
                                  pad_left, packed_input.device)
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


def _int8_conv(xq, w, stride, dilation, groups, padding="VALID"):
    """Exact conv of int8 +-1 (or 0) operands; SAME pads with 0. int32 out."""
    from ..models.layers import conv2d_int8  # the builder imports this module

    return conv2d_int8(xq, w.to(torch.int8), tuple(stride), padding,
                       groups=groups, dilation=tuple(dilation))


def _n_outside(params: BConv2DParams, in_h, in_w, out_h, out_w, fh, fw,
               pad_top, pad_left, like):
    """Out-of-image taps per output position, (1, OH, OW, 1) int32."""
    mask = outside_tap_mask_t(in_h, in_w, out_h, out_w, fh, fw,
                              params.stride, params.dilation, pad_top,
                              pad_left, like.device)
    return mask.sum(dim=(2, 3), dtype=torch.int32)[None, :, :, None]


def _pm1_filter(packed_filter, unpacked_filter, cg):
    """The (FH, FW, Cg, O) +-1 int8 filter."""
    if unpacked_filter is not None:
        return unpacked_filter.to(torch.int8)
    return bitunpack(packed_filter, cg, dtype=torch.int8).permute(1, 2, 3, 0)


def bconv2d_mxu(packed_input, packed_filter, transform: OutputTransform,
                params: BConv2DParams, output_kind: str = "float",
                unpacked_filter=None):
    """Binary conv on packed input: unpack to +-1 int8, exact integer conv,
    output transform (JAX's ``bconv2d_mxu``).

    One padding pads the packed words with 0-words (+1 values) before the
    unpack, so the conv runs VALID on real +-1 taps; zero padding is the
    integer conv's own SAME padding with 0. ``unpacked_filter`` ((FH, FW,
    Cg, O) +-1) skips the filter's unpack. Same contract as
    ``core.reference.bconv2d_reference``.
    """
    n, in_h, in_w, _ = packed_input.shape
    c_out, fh, fw, _ = packed_filter.shape
    groups = params.groups
    cg = params.channels_in // groups
    out_h, out_w, pad_top, pad_left = params.output_spatial(in_h, in_w, fh, fw)
    k = params.backtransform_add(fh, fw)
    zero_pad = params.padding == Padding.SAME and params.pad_value == 0
    if params.padding == Padding.SAME and not zero_pad:
        # 0-words unpack to +1: one padding on the packed words, 32 times
        # less data than the unpacked values.
        _, _, pad_bottom = tflite_same_padding(in_h, fh, params.stride[0],
                                               params.dilation[0])
        _, _, pad_right = tflite_same_padding(in_w, fw, params.stride[1],
                                              params.dilation[1])
        packed_input = torch.nn.functional.pad(
            packed_input, (0, 0, pad_left, pad_right, pad_top, pad_bottom))
    x = bitunpack(packed_input, params.channels_in, dtype=torch.int8)
    true_out = _int8_conv(x, _pm1_filter(packed_filter, unpacked_filter, cg),
                          params.stride, params.dilation, groups,
                          "SAME" if zero_pad else "VALID")
    if zero_pad and cg % 2:
        # Reference quirk: an out-of-image tap adds floor(c/2) to the
        # accumulator, i.e. (c mod 2) to the conv result.
        true_out = true_out + _n_outside(params, in_h, in_w, out_h, out_w,
                                         fh, fw, pad_top, pad_left, true_out)
    return _true_output_transform(true_out, transform, k, output_kind)


def _s2d_weights(w, fh, fw, c, o, stride):
    """Retile a (FH, FW, C, O) int8 filter for space-to-depth(2) execution.

    For stride 1 the output keeps its own 2x2 phase structure (4*O
    channels); for stride 2 the output phases collapse. Tap (dy, dx) of
    output phase (di, dj) lands at cell offset ((di+dy)//2, (dj+dx)//2),
    input sub-phase ((di+dy)%2, (dj+dx)%2); the rest of the retiled filter
    is zero, which adds nothing to the integer conv result.
    """
    if stride == 1:
        qh, qw = fh // 2 + 1, fw // 2 + 1
        phases = [(0, 0), (0, 1), (1, 0), (1, 1)]
    else:
        qh, qw = (fh - 1) // 2 + 1, (fw - 1) // 2 + 1
        phases = [(0, 0)]
    w2 = torch.zeros((qh, qw, 4 * c, len(phases) * o), dtype=torch.int8,
                     device=w.device)
    for p, (di, dj) in enumerate(phases):
        for dy in range(fh):
            qy, u = divmod(di + dy, 2)
            for dx in range(fw):
                qx, v = divmod(dj + dx, 2)
                ch = (u * 2 + v) * c
                w2[qy, qx, ch:ch + c, p * o:(p + 1) * o] = w[dy, dx]
    return w2, qh, qw, len(phases)


def _s2d(x):
    """(B, 2H, 2W, C) -> (B, H, W, 4C), cell channels ordered (u, v, c)."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * c)


def bconv2d_mxu_s2d(x, packed_filter, transform: OutputTransform,
                    params: BConv2DParams, output_kind: str = "float",
                    unpacked_filter=None):
    """Binary conv on float activations via space-to-depth(2) (JAX's
    ``bconv2d_mxu_s2d``): a 2x2 spatial cell folds into the channels
    (C -> 4C, and O -> 4O for stride 1), padding is applied in the sign
    domain first, and the retiled +-1/0 operands go through the same exact
    integer contraction. The integer conv result equals the direct one's.

    Requires groups == 1, dilation == 1, a square stride in {1, 2} and even
    channels_in; raises ``ValueError`` otherwise.
    """
    n, in_h, in_w, c_in = x.shape
    c_out, fh, fw, _ = packed_filter.shape
    if c_in != params.channels_in:
        raise ValueError(f"input channels {c_in} != params.channels_in "
                         f"{params.channels_in}")
    if (params.groups != 1 or params.dilation != (1, 1)
            or params.stride[0] != params.stride[1]
            or params.stride[0] not in (1, 2) or c_in % 2):
        raise ValueError("s2d path requires groups=1, dilation=1, square "
                         "stride in {1,2}, even channels_in")
    s = params.stride[0]
    out_h, out_w, pad_top, pad_left = params.output_spatial(in_h, in_w, fh, fw)
    k = params.backtransform_add(fh, fw)
    xq = torch.where(x < 0, -1, 1).to(torch.int8)
    w2, qh, qw, _ = _s2d_weights(
        _pm1_filter(packed_filter, unpacked_filter, c_in), fh, fw, c_in,
        c_out, s)
    if s == 1:
        cells_h, cells_w = ceil_div(out_h, 2), ceil_div(out_w, 2)
    else:
        cells_h, cells_w = out_h, out_w
    hp = 2 * (cells_h + qh - 1)
    wp = 2 * (cells_w + qw - 1)
    pad_val = 1 if (params.padding == Padding.SAME
                    and params.pad_value == 1) else 0
    # A stride-2 VALID conv may leave trailing rows that no kept output
    # reads, so the s2d extent is smaller than the input: crop them (exact,
    # for the same reason) rather than pad by a negative amount.
    pad_b = hp - in_h - pad_top
    pad_r = wp - in_w - pad_left
    if pad_b < 0:
        xq = xq[:, :in_h + pad_b]
        pad_b = 0
    if pad_r < 0:
        xq = xq[:, :, :in_w + pad_r]
        pad_r = 0
    xq = torch.nn.functional.pad(xq, (0, 0, pad_left, pad_r, pad_top, pad_b),
                                 value=pad_val)
    y = _int8_conv(_s2d(xq), w2, (1, 1), (1, 1), 1)
    if s == 1:
        # Inverse space-to-depth of the 2x2 output phases, then crop.
        y = y.reshape(n, cells_h, cells_w, 2, 2, c_out)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * cells_h, 2 * cells_w,
                                                c_out)
        y = y[:, :out_h, :out_w, :]
    return _true_output_transform(y, transform, k, output_kind)


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

    # The card contracts int8 through the integer conv; the CPU keeps its
    # float32 product (exact: integer partial sums below 2**24).
    on_card = x.device.type == "cuda"
    sign_dtype = torch.int8 if on_card else torch.float32
    xq = torch.where(x < 0, -1, 1).to(sign_dtype)
    if params.padding == Padding.SAME:
        # Zero padding pads the literal 0, one padding the literal +1.
        _, _, pad_bottom = tflite_same_padding(in_h, fh, sh, dh)
        _, _, pad_right = tflite_same_padding(in_w, fw, sw, dw)
        xq = torch.nn.functional.pad(
            xq, (0, 0, pad_left, pad_right, pad_top, pad_bottom),
            value=0 if zero_pad else 1)
    if on_card:
        true_out = _int8_conv(
            xq, _pm1_filter(packed_filter, unpacked_filter, cg),
            params.stride, params.dilation, groups)
    else:
        if unpacked_filter is None:
            w = bitunpack(packed_filter, cg, dtype=torch.float32)
            w = w.permute(1, 2, 3, 0)  # (FH, FW, Cg, O)
        else:
            w = unpacked_filter.to(torch.float32)
        taps = [xq[:, fy * dh:fy * dh + (out_h - 1) * sh + 1:sh,
                   fx * dw:fx * dw + (out_w - 1) * sw + 1:sw, :]
                for fy in range(fh) for fx in range(fw)]
        patches = torch.cat(taps, dim=-1)  # (N, OH, OW, FH*FW*C)
        if groups == 1:
            true_out = patches @ w.reshape(fh * fw * cg, c_out)
        else:
            opg = c_out // groups
            p = patches.reshape(n, out_h, out_w, fh * fw, groups, cg)
            p = p.permute(0, 1, 2, 4, 3, 5).reshape(n, out_h, out_w, groups,
                                                    1, fh * fw * cg)
            wg = w.reshape(fh * fw, cg, groups, opg).permute(2, 0, 1, 3)
            true_out = (p @ wg.reshape(groups, fh * fw * cg, opg)).reshape(
                n, out_h, out_w, c_out)

    if zero_pad and cg % 2:
        # Reference quirk: an out-of-image tap adds floor(c/2) to the
        # accumulator, i.e. (c mod 2) to the conv result.
        true_out = true_out + _n_outside(params, in_h, in_w, out_h, out_w,
                                         fh, fw, pad_top, pad_left,
                                         true_out).to(true_out.dtype)

    return _true_output_transform(true_out, transform, k, output_kind)


def bdense_mxu_float_in(x, kernel_pm1, transform: OutputTransform,
                        output_kind: str = "float"):
    """Binary dense on float (or int8) activations: sign to +-1 int8, the
    exact integer product with the (C, units) +-1 kernel, output transform
    (the dense layer of JAX's "mxu" lowering)."""
    from ..models.layers import int_matmul  # the builder imports this module

    xq = torch.where(x < 0, -1, 1).to(torch.int8)
    t = int_matmul(xq, kernel_pm1.to(torch.int8))
    return _true_output_transform(t, transform, kernel_pm1.shape[0],
                                  output_kind)


def bdense_mxu(packed_x, kernel_pm1, transform: OutputTransform,
               output_kind: str = "float"):
    """Binary dense on packed (M, ceil(C/32)) words: unpack to +-1 int8,
    then as ``bdense_mxu_float_in``."""
    from ..models.layers import int_matmul

    xq = bitunpack(packed_x, kernel_pm1.shape[0], dtype=torch.int8)
    t = int_matmul(xq, kernel_pm1.to(torch.int8))
    return _true_output_transform(t, transform, kernel_pm1.shape[0],
                                  output_kind)
