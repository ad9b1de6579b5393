"""Model definitions and builders for the Larq-Zoo family."""

from .builder import (  # noqa: F401
    ConvertBuilder,
    InitBuilder,
    PackedBuilder,
    convert_model,
    init_model,
    packed_apply,
    prepare_runtime_arrays,
)
from .zoo import MODELS, ModelSpec, get_model, tiny_quicknet  # noqa: F401
