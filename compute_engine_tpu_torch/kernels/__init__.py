"""Hand-written CUDA kernels of the port, each beside its plain version.

``debug_checks()`` runs the kernels' debug builds (and the plain versions'
checks) inside a block: the counterpart of ``pl.enable_debug_checks()``.
"""

from .debug import debug_checks  # noqa: F401
