"""``bmaxpool2d``: binary max-pooling op on packed words.

Counterpart of ``LceBMaxPool2d`` (LCE ``tflite/kernels/bmaxpool.cc:21-96``).
Plain torch: the JAX package computes it in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

from ..core.bmaxpool import BMaxPoolParams, bmaxpool
from ..core.types import PACKED_DTYPE, Padding

__all__ = ["bmaxpool2d"]


def bmaxpool2d(packed_input, filter_size, stride=None,
               padding: Padding = Padding.SAME):
    """Max-pool {-1, +1} data by a bitwise AND over packed windows."""
    if packed_input.dtype != PACKED_DTYPE:
        raise TypeError("bmaxpool2d input must be bitpacked int32 words")
    if isinstance(filter_size, int):
        filter_size = (filter_size, filter_size)
    if stride is None:
        stride = filter_size
    elif isinstance(stride, int):
        stride = (stride, stride)
    return bmaxpool(packed_input,
                    BMaxPoolParams(filter_size=tuple(filter_size),
                                   stride=tuple(stride), padding=padding))
