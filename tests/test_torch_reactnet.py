"""ReActNet-A on the CPU: the block kernel's plain version with the
threshold and RPReLU against a direct computation, the doubling pair's one
wide conv against its two convs, the builders' RPReLU fused and unfused,
the counters, a captured replay under the card stand-ins, the model at 32
pixels through ``PackedBuilder`` and the float builder against the
benchmark's plain reference (``portbench/reference/reactnet_a.py``), and
every other zoo model's converted layers as they were."""

import functools
import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from compute_engine_tpu_torch.core.bitpack import bitpack, bitunpack
from compute_engine_tpu_torch.core.params import BConv2DParams
from compute_engine_tpu_torch.core.transforms import (OutputTransform,
                                                      fuse_output_transform)
from compute_engine_tpu_torch.core.types import Padding
from compute_engine_tpu_torch.kernels import residual
from compute_engine_tpu_torch.kernels.residual import (
    binary_residual_block, binary_residual_block_plain, rprelu_plain)
from compute_engine_tpu_torch.models import (MODELS, PackedBuilder,
                                             convert_model, float_apply,
                                             init_model, packed_apply)
from compute_engine_tpu_torch.models.builder import (RPRELU_KEYS, _FusedSum,
                                                     _float_view, concat,
                                                     rprelu)
from compute_engine_tpu_torch.models.shapes import binary_layer_shapes
from compute_engine_tpu_torch.models.zoo import ModelSpec, reactnet_a

SIZE = 32
CLASSES = 10
SPEC = ModelSpec("reactnet_a_cpu",
                 functools.partial(reactnet_a, num_classes=CLASSES),
                 input_size=(SIZE, SIZE), num_classes=CLASSES)


@pytest.fixture(scope="module")
def params():
    return init_model(SPEC, seed=0, randomize_bn=True)


@pytest.fixture(scope="module")
def layers(params):
    return convert_model(SPEC, params)


def _images(rng, batch=2):
    return rng.normal(0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)


def _zero(monkeypatch):
    for counter in (rprelu, concat):
        for attr in ("launches", "fused", "in_place"):
            if hasattr(counter, attr):
                monkeypatch.setattr(counter, attr, 0)


# -- the block kernel's ReActNet form, plain version -------------------------


def _block_case(g, c, dtype, pad_value):
    x = (torch.randn(3, 6, 5, c, generator=g) * 2).to(dtype)
    w = torch.where(torch.rand(c, 3, 3, c, generator=g) < 0.5, -1.0, 1.0)
    post_mul = (torch.rand(c, generator=g) * 1.9 + 0.1).numpy()
    post_bias = ((torch.rand(c, generator=g) - 0.5) * 10).numpy()
    t = fuse_output_transform(post_mul, post_bias, 9 * c)
    tr = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                         multiplier=torch.as_tensor(t.multiplier),
                         bias=torch.as_tensor(t.bias))
    thr = torch.randn(c, generator=g) * 0.3
    rp = (torch.randn(c, generator=g) * 0.3,
          0.05 + 0.45 * torch.rand(c, generator=g),
          torch.randn(c, generator=g) * 0.3)
    params = BConv2DParams(channels_in=c, padding=Padding.SAME,
                           pad_value=pad_value)
    return x, w, tr, thr, rp, params


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pad_value", [0, 1])
def test_plain_form_against_a_direct_computation(dtype, pad_value):
    """``binary_residual_block_plain`` with a threshold and RPReLU is, bit
    for bit: the signs of ``x + threshold`` in float32, padded after the
    sign, the +-1 conv, ``clip(K - t) * mul + bias`` in float32 rounded to
    the stream's dtype, plus ``x``, then RPReLU in float32 from the stored
    sum, rounded once."""
    g = torch.Generator().manual_seed(pad_value)
    c = 40
    x, w, tr, thr, rp, params = _block_case(g, c, dtype, pad_value)
    got = binary_residual_block_plain(x, bitpack(w), tr, params,
                                      threshold=thr, rprelu=rp)
    s = torch.where(x.float() + thr < 0, -1.0, 1.0).permute(0, 3, 1, 2)
    s = F.pad(s, (1, 1, 1, 1), value=float(pad_value))
    t = F.conv2d(s.double(), w.permute(0, 3, 1, 2).double())
    k = 9 * c
    y = (torch.clamp(k - t, tr.clamp_min, tr.clamp_max).float()
         .permute(0, 2, 3, 1) * tr.multiplier) + tr.bias
    z = (x.float() + y.to(dtype).float()).to(dtype)
    u = z.float() + rp[0]
    u = torch.where(u < 0, u * rp[1], u)
    want = (u + rp[2]).to(dtype)
    assert torch.equal(got, want)
    # Without the threshold and RPReLU the answer differs.
    assert not torch.equal(got, binary_residual_block_plain(
        x, bitpack(w), tr, params))


def test_the_dispatcher_takes_the_react_form_on_the_cpu():
    """On a CPU tensor ``binary_residual_block`` runs the plain version in
    every form, the threshold and RPReLU included."""
    g = torch.Generator().manual_seed(3)
    x, w, tr, thr, rp, params = _block_case(g, 64, torch.bfloat16, 0)
    for form in (True, False):
        assert torch.equal(
            binary_residual_block(x, bitpack(w), tr, params, form,
                                  threshold=thr, rprelu=rp),
            binary_residual_block_plain(x, bitpack(w), tr, params, form,
                                        threshold=thr, rprelu=rp))


@pytest.mark.parametrize("kw", [dict(dtype=torch.float32),
                                dict(has_residual=False),
                                dict(has_residual="tail"),
                                dict(zero_pad=False), dict(rprelu=None),
                                dict(threshold=None)])
def test_the_kernel_takes_its_one_instantiation_only(kw):
    """The kernel's ReActNet form is bf16, zero-padded, with the add of x,
    threshold and RPReLU together: any other asks raise before a launch."""
    g = torch.Generator().manual_seed(4)
    x, _, _, thr, rp, _ = _block_case(g, 64, torch.bfloat16, 0)
    args = dict(has_residual=True, zero_pad=True, threshold=thr, rprelu=rp)
    args.update((k, v) for k, v in kw.items() if k != "dtype")
    with pytest.raises(ValueError, match="threshold and RPReLU"):
        residual._react_operands(x.to(kw.get("dtype", x.dtype)),
                                 args["has_residual"], args["zero_pad"],
                                 args["threshold"], args["rprelu"])
    assert residual._react_operands(x, True, True, thr, rp)
    assert residual._react_operands(x, False, False, None, None) == []


def test_rprelu_plain_rounds_once():
    z = torch.tensor([-2.0, -0.5, 0.0, 0.75, 3.0], dtype=torch.bfloat16)
    si, sl, so = (torch.full((5,), v) for v in (0.25, 0.1, -0.125))
    t = z.float() + si
    want = (torch.where(t < 0, t * sl, t) + so).to(torch.bfloat16)
    assert torch.equal(rprelu_plain(z, si, sl, so), want)
    assert rprelu_plain(z.float(), si, sl, so).dtype == torch.float32


# -- the doubling pair -------------------------------------------------------


@pytest.mark.parametrize("kernel", ["bgemm", "mxu", "auto"])
def test_pair_is_one_wide_conv_of_its_two(kernel, params, layers, rng):
    """The doubling pair converts into one layer of twice the width under
    its first name (filters and transforms side by side, the one shift),
    and its one conv equals its two convs, each converted alone, side by
    side, bit for bit."""
    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.models.builder import ConvertBuilder

    first, second = "block_1_conv_1x1", "block_1_conv_1x1_b"
    assert params[first]["shift"] is params[second]["shift"]
    joined = layers[first]
    assert second not in layers
    assert joined["packed_filter"].shape[0] == 128
    assert joined["shift"].shape == (64,)
    x = torch.from_numpy(rng.normal(0, 2, (2, 8, 8, 64)).astype(np.float32))
    alone = ConvertBuilder(params)
    for name in (first, second):
        alone.binary_conv_bn(x, 64, 1, padding="VALID", input_shift=True,
                             name=name)
    alone = layers_from_numpy(alone.layers, torch.device("cpu"))
    b = PackedBuilder(layers_from_numpy(layers, torch.device("cpu")),
                      kernel=kernel)
    pair = b.binary_conv_pair(x, 64, names=(first, second))
    two = PackedBuilder(alone, kernel=kernel)
    want = torch.cat([two.binary_conv_bn(x, 64, 1, padding="VALID",
                                         input_shift=True, name=n)
                      for n in (first, second)], dim=-1)
    assert pair.shape == (2, 8, 8, 128)
    assert torch.equal(pair, want)


def test_a_pair_with_two_shifts_does_not_convert(params):
    bad = {k: dict(v) for k, v in params.items()}
    bad["block_0_conv_1x1_b"]["shift"] = (
        bad["block_0_conv_1x1_b"]["shift"] + 1)
    with pytest.raises(ValueError, match="input shifts differ"):
        convert_model(SPEC, bad)


def test_add_repeated_adds_to_each_part():
    y = torch.arange(12.0).reshape(1, 1, 2, 6)
    r = torch.tensor([100.0, 200.0, 300.0])
    got = PackedBuilder({}).add_repeated(y, r)
    assert torch.equal(got, y + torch.cat([r, r]))
    with pytest.raises(ValueError):
        PackedBuilder({}).add_repeated(y, torch.ones(4))


# -- RPReLU fused and unfused, counted ---------------------------------------


def _unfused_rprelu(self, z, name):
    """``PackedBuilder.rprelu`` by the plain chain on the float view."""
    return rprelu(_float_view(z),
                  *(self.layers[name][f"rprelu_{k}"] for k in RPRELU_KEYS))


@pytest.mark.parametrize("compute_dtype,kernel", [
    (torch.bfloat16, "auto"), (torch.float32, "auto"),
    (torch.bfloat16, "bgemm")])
def test_rprelus_fuse_into_the_block(monkeypatch, rng, layers, compute_dtype,
                                     kernel):
    """Under ``"auto"`` the 9 RPReLUs after the stride-1 3x3 convs run in the
    block's launch with its threshold (``rprelu.fused``), the other 17 by
    the chain; the logits equal, bit for bit, those of the same forward
    with every RPReLU by the chain after the conv of the shifted input and
    a separate add. Under ``"bgemm"`` no block runs and nothing fuses.
    The builder concatenates nothing."""
    x = _images(rng)
    logits, forms = [], []

    def block(x, *a, has_residual=True, **kw):
        forms[-1].append((has_residual, kw.get("threshold") is not None))
        return binary_residual_block_plain(x, *a, has_residual=has_residual,
                                           **kw)

    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(PackedBuilder, "rprelu", _unfused_rprelu)
        _zero(monkeypatch)
        forms.append([])
        logits.append(packed_apply(SPEC, layers, x, kernel=kernel,
                                   device="cpu", compute_dtype=compute_dtype,
                                   return_logits=True, residual_block=block))
        blocks = kernel == "auto"
        assert (rprelu.launches, rprelu.fused) == (
            26, 9 if fused and blocks else 0)
        assert concat.launches == 0
    if blocks:
        assert forms == [[(True, True)] * 9, [(False, False)] * 9]
    else:
        assert forms == [[], []]
    assert torch.equal(logits[0], logits[1])


def test_a_fused_sum_read_by_another_consumer(layers, rng):
    """A thresholded conv's sum read by anything but its RPReLU is the conv
    of the shifted input, then the add: what the fused launch adds before
    its RPReLU."""
    from compute_engine_tpu_torch.interop import layers_from_numpy

    b = PackedBuilder(layers_from_numpy(layers, torch.device("cpu")))
    x = torch.from_numpy(rng.normal(0, 2, (2, 16, 16, 32)).astype(
        np.float32)).to(torch.bfloat16)
    y = b.binary_conv_bn(x, 32, 3, pad_value=0, input_shift=True,
                         name="block_0_conv_3x3")
    s = b.add(x, y)
    assert isinstance(s, _FusedSum)
    a = b.layers["block_0_conv_3x3"]
    conv = binary_residual_block_plain(
        x.float() + a["shift"], a["packed_filter"],
        OutputTransform(clamp_min=int(a["clamp_min"]),
                        clamp_max=int(a["clamp_max"]),
                        multiplier=a["multiplier"], bias=a["bias"]),
        BConv2DParams(channels_in=32, padding=Padding.SAME, pad_value=0),
        has_residual=False).to(torch.bfloat16)
    assert torch.equal(s.to_float(), x + conv)
    fused = b.rprelu(s, "block_0_conv_3x3")
    assert torch.equal(fused, rprelu_plain(
        x + conv, *(a[f"rprelu_{k}"] for k in RPRELU_KEYS)))


def test_rprelus_count_under_recording(monkeypatch, layers):
    """Eagerly and into the ledger under ``counts.recording`` (what a
    capture records and a replay adds): 26 RPReLUs a forward, 9 fused."""
    from compute_engine_tpu_torch.kernels import counts

    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    _zero(monkeypatch)
    packed_apply(SPEC, layers, x, device="cpu")
    assert (rprelu.launches, rprelu.fused) == (26, 9)
    with counts.recording() as ledger:
        packed_apply(SPEC, layers, x, device="cpu")
    assert ledger == {(rprelu, "launches"): 26, (rprelu, "fused"): 9}
    assert (rprelu.launches, rprelu.fused) == (26, 9)


def test_replays_under_the_card_standins(monkeypatch, rng, layers):
    """Under the card stand-ins (a captured graph, replayed on the same
    tensors), the compiled forward equals the eager one on two inputs, and
    each replay counts its 26 RPReLUs, 9 fused."""
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
    assert (rprelu.launches, rprelu.fused) == (52, 18)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- the model against the float model and the plain reference --------------


def test_packed_forward_agrees_with_the_float_model(rng, params, layers):
    """With a float32 stream the packed forward computes the QAT float
    model (``float_apply``): the same logits to float32 rounding."""
    x = _images(rng)
    got = packed_apply(SPEC, layers, x, device="cpu",
                       compute_dtype=torch.float32, return_logits=True)
    with torch.no_grad():
        want = float_apply(SPEC, params, x, device="cpu")
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(),
                               want.numpy(), atol=1e-4)


def _reference_case(stream, seed=5, rows=16):
    from portbench import check, images, spec, system

    cfg = dict(spec.config("reactnet_a"), input_size=[SIZE, SIZE],
               num_classes=CLASSES)
    params = spec.module("reference", cfg["reference"]).make_params(
        cfg, system.derive(seed, "weights"), "cpu")
    x = images.float_images(rows, SIZE, SIZE, 3,
                            system.generator(seed, "inputs", "cpu"), "cpu")
    ref = check.reference_logits(cfg, params, x, stream)
    return cfg, params, x, ref


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_packed_builder_within_the_plain_reference(stream):
    """On the reference's seeded weights, the port's ``Interpreter``
    (``PackedBuilder``) lies within rounding of ``portbench/reference/
    reactnet_a.py`` with a float32 stream, and with the configuration's
    bfloat16 stream far closer to the bfloat16 reference than the float32
    model is."""
    from compute_engine_tpu_torch.runtime import Interpreter

    from portbench import check

    cfg, params, x, ref = _reference_case(stream)
    interp = Interpreter(SPEC, convert_model(SPEC, params), kernel="auto",
                         compute_dtype=getattr(torch, stream),
                         output_mode="logits", device="cpu")
    gaps = check.row_gaps(interp(x).float(), ref)
    if stream == "float32":
        assert gaps.max() < 1e-4
    else:
        ref32 = check.reference_logits(cfg, params, x, "float32")
        assert gaps.median() < 0.25 * check.row_gaps(ref32, ref).median()


def test_float_builder_within_the_plain_reference():
    """The QAT float model (``FloatBuilder``) on the reference's seeded
    weights: the reference's float32 answers to rounding on nearly every
    row. Its BN, ``(t - mean) * scale + beta`` in float32, rounds apart
    from the reference's float64 fold, and where a value lies within that
    rounding of its next sign, the row's later signs follow another path."""
    from compute_engine_tpu_torch.models.builder import FloatBuilder

    from portbench import check

    _, params, x, ref = _reference_case("float32")
    with torch.no_grad():
        got = SPEC.forward(FloatBuilder(params), x)
    gaps = check.row_gaps(torch.log(got), torch.log_softmax(ref, -1))
    assert gaps.median() < 1e-5
    assert int((gaps < 1e-4).sum()) >= gaps.numel() - 1, gaps


def test_layers_are_the_references():
    """The zoo model's binary convs at batch 1, 8 and 128 are the
    reference's binary layers, each doubling pair one conv of twice the
    width under its first name: 3x3 zero-padded at the block's width
    (stride 2 in 4 blocks), 1x1 VALID; no binary dense."""
    from portbench import spec

    cfg = spec.config("reactnet_a")
    ref = spec.module("reference", cfg["reference"])
    want = {}
    for name, kind, shape in ref.layers(cfg):
        if kind != "binary":
            continue
        if name.endswith("_b"):
            first = name[:-2]
            kh, kw, c, o = want[first]
            want[first] = (kh, kw, c, o + shape[3])
        else:
            want[name] = tuple(shape)
    strides = [s for _, _, s in ref.blocks(cfg)]
    assert strides.count(2) == 4
    for batch in (1, 8, 128):
        convs, denses = binary_layer_shapes(MODELS["reactnet_a"], batch)
        assert denses == []
        assert {r["name"]: (r["fh"], r["fw"], r["c_in"], r["c_out"])
                for r in convs} == want
        assert len(convs) == 26
        for r, stride in zip(convs[0::2], strides):
            assert (r["stride"], r["padding"], r["pad_value"]) == (
                (stride, stride), "SAME", 0)
        for r in convs[1::2]:
            assert (r["stride"], r["padding"]) == ((1, 1), "VALID")


# -- every other model as it was ----------------------------------------------

# sha256 (first 16 hex digits) of each zoo model's ``convert_model(spec,
# init_model(spec, seed=0, randomize_bn=True))``, every layer's every array
# and field in sorted order: the converted layers before the ReActNet ops
# were added.
CONVERTED = {
    "quicknet_small": "8f6517515c8b796c", "quicknet": "07f8a5a83a5eef50",
    "quicknet_large": "54b8f9eea3036a3f", "birealnet18": "fda7a2d5a9b65cf8",
    "binary_resnet_e18": "1114d7c088258a4c",
    "binary_alexnet": "e6b0f3fc5897f0f5",
    "binary_densenet28": "a4f0ed6724ac09e6",
    "binary_densenet37": "a0cf41539aad542b",
    "binary_densenet45": "d622c3f44b7603c0",
    "meliusnet22": "088477b2ce325b98"}


def _digest(layers):
    h = hashlib.sha256()
    for name in sorted(layers):
        for k in sorted(layers[name]):
            v = layers[name][k]
            h.update(f"{name}/{k}".encode())
            h.update(repr(v).encode()
                     if isinstance(v, (str, type(None), tuple, int, float))
                     else np.asarray(v).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(CONVERTED))
def test_every_other_model_converts_as_before(name):
    spec = MODELS[name]
    assert _digest(convert_model(spec, init_model(
        spec, seed=0, randomize_bn=True))) == CONVERTED[name]


def test_reactnet_a_at_its_published_widths(params):
    """``reactnet_a``: a 32-channel stem, 13 blocks to 1024 channels, the
    pairs' shifts one tensor, each block conv's RPReLU as wide as its
    output, a 1024 -> 1000 head."""
    full = init_model(MODELS["reactnet_a"], seed=0)
    assert tuple(full["stem_conv"]["kernel"].shape) == (3, 3, 3, 32)
    assert tuple(full["head"]["kernel"].shape) == (1024, 1000)
    assert tuple(full["block_11_conv_1x1_b"]["kernel"].shape) == (
        1, 1, 512, 512)
    assert full["block_11_conv_1x1"]["rprelu"]["slope"].shape == (1024,)
    assert bool((full["block_0_conv_3x3"]["rprelu"]["slope"] == 0.25).all())
    assert not bool(full["block_0_conv_3x3"]["shift"].any())
    assert sum(n.endswith("_b") for n in full) == 5
