"""PyTorch/CUDA port of compute_engine_tpu for NVIDIA Hopper (H100).

The JAX package ``compute_engine_tpu`` is the reference; this package imports
nothing of it. Layout mirrors it: ``core/`` (types, bit layout, transforms),
``kernels/`` (hand-written CUDA kernels with their plain PyTorch versions,
sources in ``csrc/``), ``models/`` (zoo and builders), ``converter/``
(artifacts) and ``runtime/`` (Interpreter, benchmark). Entry points run on
the card unless given ``device="cpu"``.
"""
