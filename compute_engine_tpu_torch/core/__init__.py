"""Compute core of the port: types, bit layout, output-transform math, the
packed reference conv and binary max-pooling."""

from .types import (  # noqa: F401
    Activation,
    BITWIDTH,
    PACKED_DTYPE,
    Padding,
    ceil_div,
    packed_size,
    popcount,
    round_half_away,
    saturate_int8,
    xor_popcount,
)
from .bitpack import bitpack, bitpack_np, bitunpack, packed_shape  # noqa: F401
from .params import (BConv2DParams, tflite_same_padding,  # noqa: F401
                     valid_padding_out)
from .transforms import (  # noqa: F401
    OutputTransform,
    apply_output_transform_bitpacked,
    apply_output_transform_float,
    apply_output_transform_int8,
    compute_output_thresholds,
    fuse_output_transform,
    nominal_activation_range,
)
from .reference import bconv2d_reference  # noqa: F401
from .bmaxpool import BMaxPoolParams, bmaxpool  # noqa: F401
