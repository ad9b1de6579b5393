"""MeliusNet-22 on the CPU, at its full widths and depths on 32x32 images:
the improvement blocks' tail add fused on the dense block's in-place stream
against the same forward by ``torch.cat`` and a separate add, the other
pipelines, a captured replay under the card stand-ins, the QAT float model,
and the benchmark's plain reference (``portbench/reference/
meliusnet22.py``). The port's plain versions run every binary conv."""

import functools

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply)
from compute_engine_tpu_torch.models.builder import (PackedBuilder, _Base,
                                                     add_tail, concat)
from compute_engine_tpu_torch.models.zoo import ModelSpec, meliusnet22

SIZE = 32
CLASSES = 10
SPEC = ModelSpec("meliusnet22_cpu",
                 functools.partial(meliusnet22, num_classes=CLASSES),
                 input_size=(SIZE, SIZE), num_classes=CLASSES)


@pytest.fixture(scope="module")
def layers():
    return convert_model(SPEC, init_model(SPEC, seed=0, randomize_bn=True))


def _images(rng, batch=2, size=SIZE):
    return rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32)


def _zero(monkeypatch):
    for counter in (concat, add_tail):
        for attr in ("launches", "in_place", "fused"):
            if hasattr(counter, attr):
                monkeypatch.setattr(counter, attr, 0)


def _counted():
    return (concat.launches, concat.in_place, add_tail.launches,
            add_tail.fused)


def _unfused_tail(self, x, y):
    """``PackedBuilder.add_tail`` by ``torch.cat`` and a separate add."""
    from compute_engine_tpu_torch.models.builder import _float_view

    return add_tail(_float_view(x), _float_view(y))


@pytest.mark.parametrize("compute_dtype,kernel", [
    (torch.bfloat16, "auto"), (torch.float32, "auto"),
    (torch.bfloat16, "mxu")])
def test_improvements_fuse_into_the_stream_in_place(monkeypatch, rng, layers,
                                                    compute_dtype, kernel):
    """Each dense block's stream lies in one buffer: its 19 dense layers
    concatenate in place, and its 19 improvements run as the block kernel's
    tail form, written over the stream's last 64 channels
    (``add_tail.fused``); the logits equal, bit for bit, those of the same
    forward with every concatenation a ``torch.cat`` and every improvement
    the conv, then a ``torch.cat`` and an add. Under ``kernel="mxu"`` no
    block runs: nothing is in place, the logits the same."""
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)

    x = _images(rng)
    logits, forms = [], []

    def block(x, *a, has_residual=True, **kw):
        forms[-1].append(has_residual)
        return binary_residual_block_plain(x, *a, has_residual=has_residual,
                                           **kw)

    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(PackedBuilder, "dense_block",
                                _Base.dense_block)
            monkeypatch.setattr(PackedBuilder, "add_tail", _unfused_tail)
        _zero(monkeypatch)
        forms.append([])
        logits.append(packed_apply(SPEC, layers, x, kernel=kernel,
                                   device="cpu", compute_dtype=compute_dtype,
                                   return_logits=True, residual_block=block))
        blocks = kernel == "auto"
        n = 19 if fused and blocks else 0
        assert _counted() == (19, n, 19, n)
    if blocks:
        assert forms == [[False, "tail"] * 19, [False] * 38]
    else:
        assert forms == [[], []]
    assert torch.equal(logits[0], logits[1])


def test_tail_adds_count_under_recording(monkeypatch, layers):
    """Eagerly and into the ledger under ``counts.recording`` (what a
    capture records and a replay adds): 19 concatenations and 19 tail adds
    a forward, all in place and fused."""
    from compute_engine_tpu_torch.kernels import counts

    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    _zero(monkeypatch)
    packed_apply(SPEC, layers, x, device="cpu")
    assert _counted() == (19, 19, 19, 19)
    with counts.recording() as ledger:
        packed_apply(SPEC, layers, x, device="cpu")
    assert ledger == {(concat, "launches"): 19, (concat, "in_place"): 19,
                      (add_tail, "launches"): 19, (add_tail, "fused"): 19}
    assert _counted() == (19, 19, 19, 19)


@pytest.mark.parametrize("pipeline", ["int8", "packed"])
def test_the_other_pipelines_add_their_tails_unfused(monkeypatch, rng,
                                                     pipeline):
    """The true-int8 pipeline and the packed domain run MeliusNet with the
    dense block declared: nothing in place, no tail add fused, and the
    logits equal those of the same forward by ``torch.cat`` and a separate
    add throughout."""
    from compute_engine_tpu_torch.models import calibrate_model

    params = init_model(SPEC, seed=1, randomize_bn=True)
    x = _images(rng)
    kw = {}
    if pipeline == "int8":
        in_r, out_r = calibrate_model(SPEC, params, [x], with_outputs=True,
                                      device="cpu")
        net = convert_model(SPEC, params, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    else:
        net, kw = convert_model(SPEC, params), {"domain": "packed"}
    logits = []
    for declared in (True, False):
        if not declared:
            monkeypatch.setattr(PackedBuilder, "dense_block",
                                _Base.dense_block)
            monkeypatch.setattr(PackedBuilder, "add_tail", _unfused_tail)
        _zero(monkeypatch)
        logits.append(packed_apply(SPEC, net, x, device="cpu",
                                   return_logits=True, **kw))
        assert _counted() == (19, 0, 19, 0)
    assert torch.equal(logits[0], logits[1])


def test_a_fused_tail_adds_conv_cannot_be_read_alone(layers):
    """After its tail add is written over the stream, an improvement's
    conv value alone is gone: reading it raises rather than answering from
    the overwritten input."""
    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.models.builder import _DeferredBConv

    b = PackedBuilder(layers_from_numpy(layers, torch.device("cpu")))
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    x = b.dense_block(x, 192)
    y = b.binary_conv_bn(x, 64, 3, pad_value=0, name="block_0_dense_0")
    x = b.concat([x, y])
    y = b.binary_conv_bn(x, 64, 3, pad_value=0,
                         name="block_0_improvement_0")
    assert isinstance(y, _DeferredBConv)
    assert b.add_tail(x, y) is x
    with pytest.raises(RuntimeError, match="overwritten"):
        y.to_float()


def test_in_place_replays_under_the_card_standins(monkeypatch, rng, layers):
    """Under the card stand-ins (a captured graph, replayed on the same
    tensors), the compiled forward equals the eager one on two inputs, and
    one replay counts 19 concatenations in place and 19 fused tail adds:
    the tail form's result is copied into the stream on every replay."""
    import _torch_card_standins as standins

    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.compiled import CompiledForward

    standins.install(monkeypatch)
    interp = Interpreter(SPEC, layers, device="cpu", output_mode="logits")
    xs = [_images(rng) for _ in range(2)]
    want = [interp(x) for x in xs]
    interp._compiled = CompiledForward(interp._forward, torch.device("cpu"))
    interp(xs[1])  # warms up, captures
    _zero(monkeypatch)
    got = [interp(x) for x in xs]
    assert _counted() == (38, 38, 38, 38)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_packed_forward_agrees_with_the_float_model(rng, layers):
    """With a float32 stream the packed forward computes the QAT float
    model (``float_apply``): the same logits to float32 rounding."""
    from compute_engine_tpu_torch.models import float_apply

    params = init_model(SPEC, seed=0, randomize_bn=True)
    x = _images(rng)
    got = packed_apply(SPEC, layers, x, device="cpu",
                       compute_dtype=torch.float32, return_logits=True)
    with torch.no_grad():
        want = float_apply(SPEC, params, x, device="cpu")
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(),
                               want.numpy(), atol=1e-4)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_within_the_plain_reference(stream):
    """On the reference's seeded weights, the port's ``Interpreter`` lies
    within rounding of ``portbench/reference/meliusnet22.py`` with a
    float32 stream, and with the configuration's bfloat16 stream far closer
    to the bfloat16 reference than the float32 model is."""
    from compute_engine_tpu_torch.runtime import Interpreter

    from portbench import check, images, spec, system

    cfg = dict(spec.config("meliusnet22"), input_size=[SIZE, SIZE],
               num_classes=CLASSES)
    params = spec.module("reference", cfg["reference"]).make_params(
        cfg, system.derive(5, "weights"), "cpu")
    interp = Interpreter(SPEC, convert_model(SPEC, params), kernel="auto",
                         compute_dtype=getattr(torch, stream),
                         output_mode="logits", device="cpu")
    x = images.float_images(16, SIZE, SIZE, 3,
                            system.generator(5, "inputs", "cpu"), "cpu")
    served = interp(x).float()
    ref = check.reference_logits(cfg, params, x, stream)
    gaps = check.row_gaps(served, ref)
    if stream == "float32":
        assert gaps.max() < 1e-4
    else:
        ref32 = check.reference_logits(cfg, params, x, "float32")
        assert gaps.median() < 0.25 * check.row_gaps(ref32, ref).median()


def test_meliusnet22_takes_num_classes():
    """``meliusnet22(num_classes=16)``: a 640 -> 16 head, 16 logits."""
    spec = ModelSpec("m", functools.partial(meliusnet22, num_classes=16),
                     input_size=(SIZE, SIZE), num_classes=16)
    params = init_model(spec, seed=0)
    assert tuple(params["head"]["kernel"].shape) == (640, 16)
    assert tuple(params["stem_conv_1"]["kernel"].shape) == (3, 3, 8, 32)
    assert tuple(params["transition_0"]["kernel"].shape) == (1, 1, 80, 160)
    out = packed_apply(spec, convert_model(spec, params),
                       np.zeros((2, SIZE, SIZE, 3), np.float32),
                       device="cpu")
    assert out.shape == (2, 16)
