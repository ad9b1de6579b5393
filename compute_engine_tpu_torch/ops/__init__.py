"""Public functional ops on packed operands, with kernel dispatch."""

from .bconv2d import bconv2d  # noqa: F401
from .bmaxpool import bmaxpool2d  # noqa: F401
from .detection import detection_postprocess  # noqa: F401
from .quantize import dequantize, quantize  # noqa: F401
