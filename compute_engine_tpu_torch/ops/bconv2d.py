"""``bconv2d``: the public binary-convolution op on packed operands.

Counterpart of ``compute_engine_tpu.ops.bconv2d``; the checks follow LCE's
``Prepare`` (``tflite/kernels/bconv2d.cc:133-300``).
"""

from __future__ import annotations

from ..core.params import BConv2DParams
from ..core.reference import bconv2d_reference
from ..core.transforms import OutputTransform
from ..core.types import PACKED_DTYPE, packed_size
from ..kernels.bconv2d import bconv2d_bgemm
from ..kernels.bgemm import bgemm

__all__ = ["bconv2d", "KERNELS"]

KERNELS = ("auto", "reference", "bgemm")


def bconv2d(packed_input, packed_filter, transform: OutputTransform,
            params: BConv2DParams, output_kind: str = "float",
            kernel: str = "auto", gemm=bgemm):
    """Binary 2D convolution on bitpacked operands.

    Args:
      packed_input: (N, H, W, ceil(C_in/32)) int32 words.
      packed_filter: (C_out, FH, FW, ceil(C_in/groups/32)) int32 words.
      transform: fused output transform. For ``output_kind="bitpacked"`` the
        thresholds must have been computed against sign-flipped filters.
      params: static conv parameters.
      output_kind: "float" | "int8" | "bitpacked".
      kernel: "reference" (the packed oracle), "bgemm" (packed im2col + the
        binary GEMM kernel) or "auto". The port has no kernel table yet, so
        "auto" means "bgemm". JAX's "mxu" lowering (an XLA conv, not a Pallas
        kernel) waits for kernel selection.
      gemm: the binary GEMM of the "bgemm" kernel (``bgemm`` by default;
        ``bgemm_plain`` runs the plain version on the card).

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
    if kernel == "reference":
        return bconv2d_reference(packed_input, packed_filter, transform,
                                 params, output_kind)
    if kernel in ("auto", "bgemm"):
        return bconv2d_bgemm(packed_input, packed_filter, transform, params,
                             output_kind, gemm=gemm)
    raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
