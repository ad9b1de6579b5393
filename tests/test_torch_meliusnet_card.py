"""MeliusNet-22 on the card: the block kernel's tail form against its plain
version, and the launches and logits of a b128 forward. The tests are
marked ``card`` and skip without a CUDA card. The tests' ``conftest.py``
imports JAX, which the card's machine does not have, so run them there from
the root of a checkout without it:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_meliusnet_card.py
"""

import pytest

SEED = 2147480241
CONFIG = "meliusnet22"


def _improvements():
    """``(h, w, c, width)`` of MeliusNet-22's 19 improvement blocks: the
    stream's channels ``c`` as the block reads it, and its buffer's width
    (its dense block's final width)."""
    from portbench import spec

    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    layers = counts._layers(cfg)
    out = []
    for h, w, c, improvement in layers:
        if improvement:
            width = max(cc for hh, ww, cc, imp in layers
                        if imp and (hh, ww) == (h, w))
            out.append((h, w, c, width))
    return out


IMPROVEMENTS = _improvements()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _tail_case(batch, h, w, c, width, device, seed=0):
    """A (batch, h, w, width) bf16 buffer of random values, its stream
    ``buf[..., :c]`` and a zero-padded improvement conv reading it: (buf,
    packed filter, transform, params, tap_delta, +-1 filter)."""
    import torch

    from compute_engine_tpu_torch.core.bitpack import bitpack, bitunpack
    from compute_engine_tpu_torch.core.params import BConv2DParams
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.core.transforms import (
        OutputTransform, fuse_output_transform)
    from compute_engine_tpu_torch.core.types import Padding

    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(batch, h, w, width, generator=g).to(
        device, torch.bfloat16)
    pf = bitpack(torch.where(torch.rand(64, 3, 3, c, generator=g) < 0.5,
                             -1.0, 1.0)).to(device)
    post_mul = (torch.rand(64, generator=g) * 1.9 + 0.1).numpy()
    post_bias = ((torch.rand(64, generator=g) - 0.5) * 10).numpy()
    t = fuse_output_transform(post_mul, post_bias, 9 * c)
    tr = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                         multiplier=torch.as_tensor(t.multiplier).to(device),
                         bias=torch.as_tensor(t.bias).to(device))
    params = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=0)
    return (buf, pf, tr, params, zero_padding_tap_delta(pf, params),
            bitunpack(pf, c, dtype=torch.int8).permute(1, 2, 3, 0))


def _improve(block, buf, c, pf, tr, params, **kw):
    """The improvement on ``buf``: the tail form of ``buf[..., :c]`` into a
    new tensor, then copied over the stream's last 64 channels, as the
    builder does it."""
    y = block(buf[..., :c], pf, tr, params, has_residual="tail", **kw)
    buf[..., c - 64:c].copy_(y)
    return y


@pytest.mark.card
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("batch,layer", [(8, i) for i in range(19)]
                         + [(128, 0)])
def test_tail_form_equals_its_plain_version(card, checked, batch, layer):
    """At each of the 19 improvement shapes (and the first at b128), in the
    default and the debug build, the tail form on a channel prefix of the
    dense block's buffer, copied into place, leaves the whole buffer
    ``torch.equal`` to its plain version's."""
    import contextlib

    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    h, w, c, width = IMPROVEMENTS[layer]
    buf, pf, tr, params, delta, pm1 = _tail_case(batch, h, w, c, width, card,
                                                seed=layer)
    want = buf.clone()
    with debug_checks() if checked else contextlib.nullcontext():
        y = _improve(binary_residual_block, buf, c, pf, tr, params,
                     tap_delta=delta)
        y_plain = _improve(binary_residual_block_plain, want, c, pf, tr,
                           params, unpacked_filter=pm1)
    torch.cuda.synchronize()
    assert torch.equal(y, y_plain)
    assert torch.equal(buf, want)


@pytest.mark.card
def test_tail_form_debug_check_finds_an_overlapping_out(card):
    """An ``out`` over the channels the launch reads, let through on
    purpose, trips the tail form's debug check; the default layout does
    not."""
    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    h, w, c, width = IMPROVEMENTS[-1]
    buf, pf, tr, params, delta, _ = _tail_case(2, h, w, c, width, card)
    with debug_checks():
        binary_residual_block(buf[..., :c], pf, tr, params,
                              has_residual="tail", tap_delta=delta)
        with pytest.raises(RuntimeError, match="tail form"):
            binary_residual_block(buf[..., :c], pf, tr, params,
                                  has_residual="tail", tap_delta=delta,
                                  out=buf[..., c - 64:c],
                                  _debug_overlap=True)


def _forward_counts(interp, x, forwards=3):
    """Launches and tail adds a forward of the compiled ``interp`` on
    ``x`` (after one call that compiles it), and the CUDA kernels the
    profiler saw, with their launches a forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from compute_engine_tpu_torch.models.builder import add_tail, concat

    from portbench import system

    def counted():
        return dict(system.launch_counts(),
                    concat=concat.launches, in_place=concat.in_place,
                    add_tail=add_tail.launches, fused=add_tail.fused)

    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = counted()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            interp(x)
        torch.cuda.synchronize()
    after = counted()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0) + e.count / forwards
    return {k: (after[k] - before[k]) / forwards for k in after}, kernels


@pytest.mark.card
def test_b128_forward_launches(card):
    """Through the benchmark's path (``portbench.system.build``:
    ``convert_model``, ``Interpreter`` with ``kernel="auto"``, one CUDA
    graph), each b128 forward launches the block kernel 38 times and the
    binary GEMM never; its 19 concatenations are all in place and its 19
    tail adds all fused; the profiler sees the tail form's kernel 19 times
    a forward and no ``CatArrayBatchedCopy``."""
    import torch

    from portbench import images, spec, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    _, interp, _ = system.build(cfg, SEED, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(SEED, "inputs", card), card)
    per_forward, kernels = _forward_counts(interp, x)
    assert per_forward == {"residual_block": 38, "bgemm": 0,
                           "bgemm_splitk": 0, "concat": 19, "in_place": 19,
                           "add_tail": 19, "fused": 19}
    assert sum(n for k, n in kernels.items()
               if "tail_residual_block_kernel" in k) == 19, kernels
    assert not [k for k in kernels if "CatArrayBatchedCopy" in k]
    out = interp(x)
    assert out.shape == (128, cfg["num_classes"])
    assert bool(torch.isfinite(out).all())


@pytest.mark.card
def test_logits_equal_the_unfused_improvements(card, monkeypatch):
    """The b128 forward's logits (eager, the runtime's layers) equal, bit
    for bit, those of the same forward with every improvement done by the
    block kernel without the add, then ``torch.cat`` and a separate add
    (``add_tail`` unfused), which count no fused tail add."""
    import torch

    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 packed_apply,
                                                 prepare_runtime_arrays)
    from compute_engine_tpu_torch.models.builder import (PackedBuilder,
                                                         _float_view,
                                                         add_tail)

    from portbench import images, spec, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    model = get_model(cfg["model"])
    ref = spec.module("reference", cfg["reference"])
    params = ref.make_params(cfg, system.derive(SEED, "weights"), card)
    layers = layers_from_numpy(prepare_runtime_arrays(
        convert_model(model, params)), card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(SEED, "inputs", card), card)
    fused = packed_apply(model, layers, x, return_logits=True)
    monkeypatch.setattr(PackedBuilder, "add_tail",
                        lambda self, s, y: add_tail(_float_view(s),
                                                    _float_view(y)))
    before = add_tail.fused
    unfused = packed_apply(model, layers, x, return_logits=True)
    torch.cuda.synchronize()
    assert add_tail.fused == before
    assert torch.equal(fused, unfused)
