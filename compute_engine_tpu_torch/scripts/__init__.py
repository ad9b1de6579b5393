"""The repo's tools, run on the card: the counterparts of the JAX repo's
``scripts/``, each a runnable module
(``python -m compute_engine_tpu_torch.scripts.<name>``):

- ``accuracy_fixtures``: trained 224x224 accuracy records of the flagship
  models (``tests/fixtures/torch_accuracy_224.json``);
- ``baseline_matrix``: the baseline configurations' latency, throughput and
  serving rows (``baseline_matrix_h100.json`` beside it);
- ``section_profile``: QuickNet per section against its floors
  (``section_profile_h100.json``);
- ``tp_scaling_report``: data-parallel scaling and the tensor-parallel modes
  (``tp_scaling_h100.json``);
- ``ci.sh``: compile check, the port's CPU tests, then ``chip_smoke.py``
  when a card is listed.

Every function takes ``device=`` (the card by default) and nothing runs at
import.
"""
