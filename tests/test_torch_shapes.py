"""The port's enumeration of binary-layer shapes (``models/shapes.py``)
against the JAX package's, record for record."""

import pytest

from compute_engine_tpu.models.shapes import (binary_layer_shapes as
                                              jbinary_layer_shapes)
from compute_engine_tpu.models.zoo import MODELS as JMODELS

from compute_engine_tpu_torch.models.shapes import binary_layer_shapes
from compute_engine_tpu_torch.models.zoo import MODELS


# The port's own models, which the JAX package does not have.
PORT_ONLY = ("meliusnet22", "reactnet_a")


def test_same_zoo():
    """The JAX package's models first, in its order; then exactly the
    port's own."""
    names = list(MODELS)
    assert names[:len(JMODELS)] == list(JMODELS)
    assert tuple(names[len(JMODELS):]) == PORT_ONLY


@pytest.mark.parametrize("model", list(JMODELS))
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


def test_meliusnet22_binary_layer_shapes_match_the_plain_reference():
    """MeliusNet-22's binary convs at batch 1, 8 and 128 are the plain
    reference's binary layers (``portbench/reference/meliusnet22.py``), in
    order, by name and kernel shape, at the stream's sizes that its counts
    give: 3x3, stride 1, SAME with zero padding, ungrouped, 64 out; no
    binary dense."""
    from portbench import spec

    cfg = spec.config("meliusnet22")
    ref = spec.module("reference", cfg["reference"])
    want = [(name, shape) for name, kind, shape in ref.layers(cfg)
            if kind == "binary"]
    sizes = [(h, w) for h, w, _, _ in
             spec.module("counts", cfg["counts"])._layers(cfg)]
    assert len(want) == len(sizes) == 38
    for batch in (1, 8, 128):
        convs, denses = binary_layer_shapes(MODELS["meliusnet22"],
                                            batch=batch)
        assert denses == []
        assert [(r["name"], (r["fh"], r["fw"], r["c_in"], r["c_out"]))
                for r in convs] == want
        assert [(r["h"], r["w"]) for r in convs] == sizes
        for r in convs:
            assert (r["stride"], r["padding"], r["pad_value"], r["groups"],
                    r["dilation"]) == ((1, 1), "SAME", 0, 1, (1, 1))
            assert (r["out_h"], r["out_w"]) == (r["h"], r["w"])
            assert r["m"] == batch * r["h"] * r["w"]
