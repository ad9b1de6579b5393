"""``bconv2d``: the public binary-convolution op on packed operands.

Counterpart of ``compute_engine_tpu.ops.bconv2d``; the checks follow LCE's
``Prepare`` (``tflite/kernels/bconv2d.cc:133-300``).
"""

from __future__ import annotations

from ..core.params import BConv2DParams
from ..core.reference import bconv2d_reference
from ..core.transforms import OutputTransform
from ..core.types import PACKED_DTYPE, Padding, packed_size
from ..kernels.bconv2d import bconv2d_bgemm, bconv2d_mxu
from ..kernels.bgemm import bgemm
from ..kernels.select import layer_lowering

__all__ = ["bconv2d", "KERNELS"]

KERNELS = ("auto", "reference", "bgemm", "mxu")


def bconv2d(packed_input, packed_filter, transform: OutputTransform,
            params: BConv2DParams, output_kind: str = "float",
            kernel: str = "auto", gemm=bgemm, unpacked_filter=None):
    """Binary 2D convolution on bitpacked operands.

    Args:
      packed_input: (N, H, W, ceil(C_in/32)) int32 words.
      packed_filter: (C_out, FH, FW, ceil(C_in/groups/32)) int32 words.
      transform: fused output transform. For ``output_kind="bitpacked"`` the
        thresholds must have been computed against sign-flipped filters.
      params: static conv parameters.
      output_kind: "float" | "int8" | "bitpacked".
      kernel: "reference" (the packed oracle), "bgemm" (packed im2col + the
        binary GEMM kernel), "mxu" (unpack to +-1 int8 and the exact integer
        conv) or "auto", which asks ``kernels.select`` for the packed
        domain's choice at this shape.
      gemm: the binary GEMM of the "bgemm" kernel (``bgemm`` by default;
        ``bgemm_plain`` runs the plain version on the card).
      unpacked_filter: optional (FH, FW, Cg, O) +-1 filter for "mxu".

    Returns (N, OH, OW, C_out) float32/int8, or (N, OH, OW, ceil(C_out/32))
    int32 words.
    """
    if packed_input.dtype != PACKED_DTYPE:
        raise TypeError(f"packed_input must be {PACKED_DTYPE}, got "
                        f"{packed_input.dtype}")
    if packed_input.dim() != 4 or packed_filter.dim() != 4:
        raise ValueError("bconv2d operands must be rank 4")
    expect_cpg = packed_size(params.channels_in_per_group)
    if packed_filter.shape[3] != expect_cpg:
        raise ValueError(
            f"packed filter depth {packed_filter.shape[3]} does not match "
            f"channels_in={params.channels_in} / groups={params.groups}")
    if packed_input.shape[3] != params.groups * expect_cpg:
        raise ValueError(
            f"packed input depth {packed_input.shape[3]} does not match "
            f"groups * packed filter depth {params.groups * expect_cpg}")
    if params.groups > 1 and params.channels_in_per_group % 32:
        raise ValueError(
            "grouped bconv2d requires channels_in/groups to be a multiple of "
            "32 (`prepare_tf.cc:121-146` divisibility rule)")
    if output_kind not in ("float", "int8", "bitpacked"):
        raise ValueError(f"unknown output_kind {output_kind!r}")
    if kernel == "auto":
        n, in_h, in_w, _ = packed_input.shape
        _, fh, fw, _ = packed_filter.shape
        out_h, out_w, _, _ = params.output_spatial(in_h, in_w, fh, fw)
        kernel = layer_lowering("auto", dict(
            c_in=params.channels_in, c_out=packed_filter.shape[0], fh=fh,
            fw=fw, m=n * out_h * out_w, stride=params.stride,
            padding="SAME" if params.padding == Padding.SAME else "VALID",
            pad_value=params.pad_value, groups=params.groups,
            dilation=params.dilation), "packed", output_kind)
    if kernel == "reference":
        return bconv2d_reference(packed_input, packed_filter, transform,
                                 params, output_kind)
    if kernel == "bgemm":
        return bconv2d_bgemm(packed_input, packed_filter, transform, params,
                             output_kind, gemm=gemm)
    if kernel == "mxu":
        return bconv2d_mxu(packed_input, packed_filter, transform, params,
                           output_kind, unpacked_filter=unpacked_filter)
    raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
