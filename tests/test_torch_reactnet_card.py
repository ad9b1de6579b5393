"""ReActNet-A on the card: the block kernel's ReActNet form (the threshold
in the band's signing, RPReLU after the add) against its plain version,
and the launches, RPReLUs and logits of a b128 forward. The tests are
marked ``card`` and skip without a CUDA card. The tests' ``conftest.py``
imports JAX, which the card's machine does not have, so run them there from
the root of a checkout without it:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_reactnet_card.py
"""

import pytest

from chip_smoke import react_case, react_stride1_shapes

SEED = 2147626101
CONFIG = "reactnet_a"
SHAPES = react_stride1_shapes()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_react_form_equals_its_plain_version(card, checked, batch, shape):
    """At each of ReActNet-A's stride-1 3x3 shapes, b1 and b128, in the
    default and the debug build: the kernel with the threshold, the add of
    x and RPReLU ``torch.equal`` to its plain version, and counted in
    ``threshold_launches``."""
    import contextlib

    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    h, w, c = SHAPES[shape]
    x, pf, tr, params, delta, pm1, thr, rp = react_case(batch, h, w, c, card,
                                                        seed=shape)
    before = binary_residual_block.threshold_launches
    with debug_checks() if checked else contextlib.nullcontext():
        got = binary_residual_block(x, pf, tr, params, tap_delta=delta,
                                    threshold=thr, rprelu=rp)
    want = binary_residual_block_plain(x, pf, tr, params, unpacked_filter=pm1,
                                       threshold=thr, rprelu=rp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert binary_residual_block.threshold_launches == before + 1
    # The threshold moves signs: without it the answer differs.
    unshifted = binary_residual_block_plain(x, pf, tr, params,
                                            unpacked_filter=pm1, rprelu=rp)
    assert not torch.equal(got, unshifted)


@pytest.mark.card
def test_react_form_runs_only_where_instantiated(card):
    """The ReActNet form is bf16, zero-padded, with the add of x: a
    float32 input, the conv without the add, or a threshold without its
    RPReLU raise before any launch."""
    import torch

    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    x, pf, tr, params, delta, _, thr, rp = react_case(2, 7, 7, 64, card)
    for kw in (dict(x=x.float()), dict(has_residual=False),
               dict(rprelu=None)):
        args = dict(x=x, has_residual=True, rprelu=rp) | kw
        with pytest.raises(ValueError, match="threshold and RPReLU"):
            binary_residual_block(args["x"], pf, tr, params,
                                  has_residual=args["has_residual"],
                                  tap_delta=delta, threshold=thr,
                                  rprelu=args["rprelu"])
    torch.cuda.synchronize()


def _system(card):
    """The benchmark's system for the cell (``portbench.system.build``) and
    a b128 batch of its inputs."""
    from portbench import images, spec, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    params, interp, _ = system.build(cfg, SEED, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(SEED, "inputs", card), card)
    return cfg, params, interp, x


def expected_pointwise_launches(batch):
    """The binary GEMM's launches a forward that the committed table's
    choices give ReActNet-A's 1x1 convs at ``batch``."""
    from compute_engine_tpu_torch.kernels import select
    from compute_engine_tpu_torch.models import get_model
    from compute_engine_tpu_torch.models.shapes import binary_layer_modes

    gemm = 0
    for _, r, domain, out_kind in binary_layer_modes(get_model(CONFIG),
                                                     batch):
        k = select.layer_lowering("auto", r, domain, out_kind)
        if r["fh"] == 1:
            gemm += sum(select.layer_launches(k, r)[1:])
    return gemm


def _forward_counts(interp, x, forwards=3):
    """Launches and RPReLUs a forward of the compiled ``interp`` on ``x``
    (after one call that compiles it), and the CUDA kernels the profiler
    saw, with their launches a forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)
    from compute_engine_tpu_torch.models.builder import concat, rprelu

    from portbench import system

    def counted():
        return dict(system.launch_counts(),
                    threshold=binary_residual_block.threshold_launches,
                    rprelu=rprelu.launches, fused=rprelu.fused,
                    concat=concat.launches)

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


def _stride2_concatenations(interp, card):
    """``CatArrayBatchedCopy`` launches of the four stride-2 3x3 convs alone
    at b128 (the "mxu" lowering's im2col), each run once by the builder
    the forward runs them with, on the layers it runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from compute_engine_tpu_torch.models import PackedBuilder

    from portbench import spec

    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    b = PackedBuilder(interp.layers, return_logits=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            for i, (h, w, c, _, stride) in enumerate(counts._blocks(cfg)):
                if stride == 2:
                    x = torch.randn(128, h, w, c, device=card).to(
                        torch.bfloat16)
                    b.binary_conv_bn(x, c, 3, stride=2, pad_value=0,
                                     input_shift=True,
                                     name=f"block_{i}_conv_3x3")
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "CatArrayBatchedCopy" in e.key)


@pytest.mark.card
def test_b128_forward_launches(card):
    """Through the benchmark's path (``portbench.system.build``:
    ``convert_model``, ``Interpreter`` with ``kernel="auto"``, one CUDA
    graph), each b128 forward launches the block kernel 9 times, every one
    its ReActNet form, and the binary GEMM once for each 1x1 conv the
    table sends to it; of the 26 RPReLUs the 9 after the stride-1 3x3
    convs are fused; the builder concatenates nothing (the pairs are one
    GEMM each) and every ``CatArrayBatchedCopy`` the profiler sees is the
    stride-2 convs' im2col."""
    import torch

    cfg, _, interp, x = _system(card)
    per_forward, kernels = _forward_counts(interp, x)
    assert per_forward == {"residual_block": 9, "threshold": 9,
                           "bgemm": expected_pointwise_launches(128),
                           "bgemm_splitk": 0, "rprelu": 26, "fused": 9,
                           "concat": 0}, per_forward
    assert sum(n for k, n in kernels.items()
               if "react_residual_block_kernel" in k) == 9, kernels
    cats = sum(n for k, n in kernels.items() if "CatArrayBatchedCopy" in k)
    assert cats == _stride2_concatenations(interp, card), kernels
    out = interp(x)
    assert out.shape == (128, cfg["num_classes"])
    assert bool(torch.isfinite(out).all())


@pytest.mark.card
def test_logits_equal_the_unfused_rprelus(card, monkeypatch):
    """The b128 forward's logits (eager, the runtime's layers) equal, bit
    for bit, those of the same forward with every RPReLU by the plain chain
    after the conv of the materialised ``x + threshold`` and a separate
    add, which launches no ReActNet form and fuses no RPReLU."""
    import torch

    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 packed_apply,
                                                 prepare_runtime_arrays)
    from compute_engine_tpu_torch.models.builder import (PackedBuilder,
                                                         RPRELU_KEYS,
                                                         _float_view, rprelu)

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
    monkeypatch.setattr(
        PackedBuilder, "rprelu", lambda self, z, name: rprelu(
            _float_view(z),
            *(self.layers[name][f"rprelu_{k}"] for k in RPRELU_KEYS)))
    before = (rprelu.fused, binary_residual_block.threshold_launches)
    unfused = packed_apply(model, layers, x, return_logits=True)
    torch.cuda.synchronize()
    assert (rprelu.fused, binary_residual_block.threshold_launches) == before
    assert torch.equal(fused, unfused)
