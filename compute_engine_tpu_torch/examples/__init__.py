"""Examples of the port's public API: ``e2e_smoke`` (``python -m
compute_engine_tpu_torch.examples.e2e_smoke``), the op-level user flow on
the card."""
