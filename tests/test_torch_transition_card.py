"""The transition kernel (``kernels/transition.py``,
``csrc/transition_conv_pool.cu``) on the card. The tests are marked
``card`` and skip without a CUDA card. The tests' ``conftest.py`` imports
JAX, which the card's machine does not have, so run them there from the
root of a checkout without it:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_transition_card.py

Tolerance: the kernel and its plain version (cuDNN's conv, PyTorch's pool)
take the same bf16 operands, whose products are exact, and differ only in
the order of one float32 sum of C_in products before each conv output is
rounded to bf16. So each pooled output lies within one bf16 ulp of the
plain version's, and of the same transition with exact (float64) sums,
except where a sum cancels, where it may lie as far as reordering the
float32 sums of its window moves it (``transition.within_tolerance``).
"""

import numpy as np
import pytest

SEED = 2147625031
# BinaryDenseNet-45's transitions: (height = width, C_in, C_out).
TRANSITIONS = ((56, 448, 160), (28, 928, 256), (14, 1152, 288))
CELL = "binary-densenet45-offline-b128"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _inputs(batch, shape, device, prefix=0):
    """A bf16 stream (the first C_in channels of a buffer ``prefix``
    channels wider), a folded 1x1 kernel and a bias, drawn on the card."""
    import torch

    hw, c, c_out = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + batch + c + prefix)
    buf = torch.randn((batch, hw, hw, c + prefix), generator=gen,
                      device=device).to(torch.bfloat16)
    buf.view(-1)[::97] = 0.0
    kernel = torch.randn((1, 1, c, c_out), generator=gen,
                         device=device) * (2.0 / c) ** 0.5
    bias = torch.randn((c_out,), generator=gen, device=device) * 0.5
    return buf[..., :c], kernel, bias


@pytest.mark.card
@pytest.mark.parametrize("shape", TRANSITIONS)
@pytest.mark.parametrize("batch, prefix", [(1, 0), (3, 0), (128, 0),
                                           (3, 64)])
def test_kernel_within_one_ulp(card, batch, prefix, shape):
    """The kernel against its plain version and against the exact sums at
    each of DenseNet-45's transitions, on a dense stream and on a channel
    prefix of a buffer 64 channels wider."""
    import torch

    from compute_engine_tpu_torch.kernels import transition as tr

    x, kernel, bias = _inputs(batch, shape, card, prefix)
    launches = tr.transition_conv_pool.launches
    got = tr.transition_conv_pool(x, kernel, bias,
                                  filter_bf16=tr.transition_filter(kernel))
    torch.cuda.synchronize()
    assert tr.transition_conv_pool.launches == launches + 1
    hw, _, c_out = shape
    assert got.shape == (batch, hw // 2, hw // 2, c_out)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    for want in (tr.transition_conv_pool_plain(x, kernel, bias),
                 tr.transition_conv_pool_exact(x, kernel, bias)):
        ok, ulps = tr.within_tolerance(got, want, x, kernel, bias)
        assert bool(ok.all()), (int((~ok).sum()), float(ulps.max()))


@pytest.mark.card
def test_debug_build_holds_and_trips_the_tile_check(card):
    """The debug build is silent at the kernel's own tile and at one
    element more than its farthest read, and trips at the farthest read;
    its result equals the default build's."""
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels import transition as tr

    x, kernel, bias = _inputs(2, TRANSITIONS[1], card)
    want = tr.transition_conv_pool(x, kernel, bias)
    farthest = tr.farthest_read(tr.plan_transition(*x.shape,
                                                   kernel.shape[3]))
    with debug_checks():
        assert torch.equal(tr.transition_conv_pool(x, kernel, bias), want)
        tr.transition_conv_pool(x, kernel, bias,
                                _debug_tile_elems=farthest + 1)
        with pytest.raises(RuntimeError, match="transition"):
            tr.transition_conv_pool(x, kernel, bias,
                                    _debug_tile_elems=farthest)
            torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("model, launches", [("binary_densenet45", 3),
                                             ("quicknet", 0),
                                             ("birealnet18", 0),
                                             ("meliusnet22", 0)])
def test_transition_launches_a_forward(card, model, launches):
    """A b128 forward through ``Interpreter`` (one CUDA graph) launches
    the transition kernel three times in DenseNet-45 and never in
    QuickNet, Bi-RealNet-18 or MeliusNet-22."""
    import torch

    from compute_engine_tpu_torch.kernels import transition as tr
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.runtime import Interpreter

    spec = get_model(model)
    interp = Interpreter(spec, convert_model(spec, init_model(spec, seed=0)),
                         output_mode="logits", device=card)
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1, (128, 224, 224, 3)).astype(np.float32)).to(card)
    interp(x).cpu()  # compiles: the capture is not counted
    before = tr.transition_conv_pool.launches
    forwards = 3
    for _ in range(forwards):
        interp(x)
    torch.cuda.synchronize()
    assert tr.transition_conv_pool.launches - before == launches * forwards


@pytest.mark.card
def test_densenet45_logits_within_the_cells_limits(card, monkeypatch):
    """Through the benchmark's path (``portbench.system.build``), a b128
    forward with the kernel is ``correct`` against the plain reference
    under the cell's limits, as the same forward with the transitions'
    chain (the path before the kernel) is, and lies from that forward
    within the same limits."""
    import torch

    from compute_engine_tpu_torch.kernels import transition as tr

    from portbench import check, images, spec, system

    cfg = spec.config("binary_densenet45")
    limits = spec.workload(CELL)["check"]["limits"]
    system.set_float32_flags(cfg)
    params, interp, _ = system.build(cfg, SEED, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(SEED, "inputs", card), card)
    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = tr.transition_conv_pool.launches
    got = interp(x).cpu()
    assert tr.transition_conv_pool.launches - before == 3
    del interp
    monkeypatch.setattr(tr, "transition_supported", lambda *a, **kw: False)
    _, chain_interp, _ = system.build(cfg, SEED, card)
    chain = chain_interp(x).cpu()
    del chain_interp
    torch.cuda.empty_cache()
    ref = check.reference_logits(cfg, params, x)
    unit = check.scale(cfg, params, x, ref)
    for out in (got, chain):
        correct, checks = check.judge(check.row_gaps(out, ref), unit, limits)
        assert correct, checks
    apart = check.numbers(check.row_gaps(got, chain), unit)
    assert all(apart[k] <= limits[k] for k in apart), apart
