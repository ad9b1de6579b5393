"""BinaryDenseNet-45's dense stream in place, on the card. The test is
marked ``card`` and skips without a CUDA card. The tests' ``conftest.py``
imports JAX, which the card's machine does not have, so run it there from
the root of a checkout without it:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_densenet_card.py
"""

import pytest

SEED = 2147480211


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.mark.card
def test_b128_forward_concatenates_in_place(card):
    """Through the benchmark's path (``portbench.system.build``:
    ``convert_model``, ``Interpreter`` with ``kernel="auto"``, one CUDA
    graph), each b128 forward of BinaryDenseNet-45 makes 40
    concatenations, all 40 in place, and the profiler sees the block
    kernel run and no ``CatArrayBatchedCopy`` kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from compute_engine_tpu_torch.models.builder import concat

    from portbench import images, spec, system

    cfg = spec.config("binary_densenet45")
    system.set_float32_flags(cfg)
    _, interp, _ = system.build(cfg, SEED, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(SEED, "inputs", card), card)
    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = (concat.launches, concat.in_place)
    forwards = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            interp(x)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    assert (concat.launches - before[0],
            concat.in_place - before[1]) == (40 * forwards, 40 * forwards)
    assert any("residual_block_kernel" in k for k in kernels), kernels
    assert not [k for k in kernels if "CatArrayBatchedCopy" in k]
