"""The port's enumeration of binary-layer shapes (``models/shapes.py``)
against the JAX package's, record for record."""

import pytest

from compute_engine_tpu.models.shapes import (binary_layer_shapes as
                                              jbinary_layer_shapes)
from compute_engine_tpu.models.zoo import MODELS as JMODELS

from compute_engine_tpu_torch.models.shapes import binary_layer_shapes
from compute_engine_tpu_torch.models.zoo import MODELS


def test_same_zoo():
    assert list(MODELS) == list(JMODELS)


@pytest.mark.parametrize("model", list(MODELS))
def test_binary_layer_shapes_match_jax(model):
    """Every record equal, keys and values, at batch 1, 8 and 128."""
    for batch in (1, 8, 128):
        convs, denses = binary_layer_shapes(MODELS[model], batch=batch)
        jconvs, jdenses = jbinary_layer_shapes(JMODELS[model], batch=batch)
        assert convs or denses
        assert convs == jconvs, (model, batch)
        assert denses == jdenses, (model, batch)
        for r in convs:
            assert r["m"] == batch * r["out_h"] * r["out_w"]
