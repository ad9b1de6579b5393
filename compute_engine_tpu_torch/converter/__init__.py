"""Model converter: float parameter trees -> packed inference artifacts."""

from ..models.builder import convert_model as convert  # noqa: F401
from .artifact import (load_artifact, merge_arrays,  # noqa: F401
                       save_artifact, split_arrays)
