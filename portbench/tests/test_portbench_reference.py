"""Each plain reference against the port's CPU forward, at small sizes.

With a float32 stream both compute the same float32 model and agree to
rounding; with the configuration's bfloat16 stream they round at the same
points, so most rows agree exactly and the rest by a sign that a rounding
flipped.
"""

import pytest
import torch

from portbench import check, images, spec, system

from portbench.tests.conftest import tiny

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _both(name, stream, seed=3, rows=16):
    from compute_engine_tpu_torch.models import convert_model
    from compute_engine_tpu_torch.runtime.interpreter import Interpreter

    cfg, model = tiny(name)
    ref = spec.module("reference", cfg["reference"])
    params = ref.make_params(cfg, system.derive(seed, "weights"), "cpu")
    interp = Interpreter(model=model, layers=convert_model(model, params),
                         kernel="auto", compute_dtype=getattr(torch, stream),
                         output_mode="logits", device="cpu")
    h, w = cfg["input_size"]
    x = images.float_images(rows, h, w, 3,
                            system.generator(seed, "inputs", "cpu"), "cpu")
    return interp(x).float(), check.reference_logits(cfg, params, x, stream)


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_stream_agrees(name):
    served, ref = _both(name, "float32")
    assert check.row_gaps(served, ref).max() < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_bfloat16_stream_agrees(name):
    """The program lies far closer to the bfloat16-stream reference than
    the float32 model does: it rounds where the reference rounds."""
    served, ref = _both(name, "bfloat16")
    _, ref32 = _both(name, "float32")
    program = check.row_gaps(served, ref).median()
    float32_model = check.row_gaps(ref32, ref).median()
    assert program < 0.25 * float32_model


@pytest.mark.parametrize("name", CONFIGS)
def test_layers_are_the_ports(name):
    """The reference's layer list has the port's layer names and kernel
    shapes, at the configuration's full size."""
    from compute_engine_tpu_torch.models import get_model, init_model

    cfg = spec.config(name)
    ref = spec.module("reference", cfg["reference"])
    ported = init_model(get_model(cfg["model"]))
    mine = {n: tuple(shape) for n, _, shape in ref.layers(cfg)}
    assert mine == {n: tuple(p["kernel"].shape) for n, p in ported.items()}


def test_weights_follow_the_seed():
    cfg, _ = tiny("quicknet")
    ref = spec.module("reference", cfg["reference"])
    a = ref.make_params(cfg, 7, "cpu")
    b = ref.make_params(cfg, 7, "cpu")
    c = ref.make_params(cfg, 8, "cpu")
    assert torch.equal(a["head"]["kernel"], b["head"]["kernel"])
    assert not torch.equal(a["head"]["kernel"], c["head"]["kernel"])
    bn = a["section_0_block_0"]["bn"]
    assert set(bn) == {"gamma", "beta", "moving_mean", "moving_variance"}
    assert bool((bn["moving_variance"] > 0).all())


def test_control_rounds_coarser():
    """The float8 stream is the control: coarser than bfloat16's."""
    x = torch.randn(4096) * 30
    bf = (check_round("bfloat16", x) - x).abs().max()
    f8 = (check_round("float8", x) - x).abs().max()
    assert f8 > 4 * bf


def check_round(dtype, x):
    from portbench.reference.plain import Rounder

    return Rounder(dtype)(x)
