"""Multi-device parallelism: mesh construction, sharding specs, tensor-
parallel binary convolution and the sharded forward.

The counterpart of ``compute_engine_tpu.parallel``. JAX's is single-
controller, with XLA's GSPMD inserting the collectives; so is the port's:
one process drives a grid of device slots (``mesh``), and the collectives
are explicit copies between them (``collective``, ``partition``):
  data parallelism   -> batch sharding over the "data" mesh axis
  tensor parallelism -> output-channel sharding over "model"
"""

from .collective import tp_bconv2d  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    artifact_shardings,
    input_sharding,
    shard_artifact,
)
