"""Model converter: float parameter trees -> packed inference artifacts.

  convert(spec, params)             -> artifact layer dict
  save_artifact / load_artifact     -> .npz packed-weight artifact
  keras_import.import_keras_weights -> map a Larq/Keras model onto a known
                                       spec's params
  import_keras_model(model)         -> (spec, params) from the Keras graph
                                       alone; its graph program, stored in an
                                       artifact's header, makes the artifact
                                       self-contained (spec_from_program)
"""

from ..models.builder import convert_model as convert  # noqa: F401
from .artifact import (load_artifact, merge_arrays,  # noqa: F401
                       save_artifact, split_arrays)
from .graph_import import (graph_int8_ranges,  # noqa: F401
                           import_keras_model, spec_from_program)
