"""Compute core of the port: types, bit layout, output-transform math."""

from .types import (  # noqa: F401
    Activation,
    BITWIDTH,
    PACKED_DTYPE,
    Padding,
    ceil_div,
    packed_size,
    round_half_away,
    saturate_int8,
)
from .bitpack import bitpack, bitpack_np, bitunpack, packed_shape  # noqa: F401
from .params import (BConv2DParams, tflite_same_padding,  # noqa: F401
                     valid_padding_out)
from .transforms import (  # noqa: F401
    OutputTransform,
    apply_output_transform_float,
    apply_output_transform_int8,
    compute_output_thresholds,
    fuse_output_transform,
    nominal_activation_range,
)
