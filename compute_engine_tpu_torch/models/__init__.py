"""Model definitions and builders for the Larq-Zoo family."""

from .builder import (  # noqa: F401
    CalibrateBuilder,
    ConvertBuilder,
    FloatBuilder,
    InitBuilder,
    Int8Tensor,
    KERNELS,
    PackedBuilder,
    calibrate_model,
    convert_model,
    float_apply,
    init_model,
    packed_apply,
    prepare_runtime_arrays,
)
from .train import synthetic_clustered, train_briefly  # noqa: F401
from .zoo import MODELS, ModelSpec, get_model, tiny_quicknet  # noqa: F401
