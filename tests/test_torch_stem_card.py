"""The stem kernel (``kernels/stem.py``, ``csrc/stem_conv_pool.cu``) on the
card. The tests are marked ``card`` and skip without a CUDA card. The
tests' ``conftest.py`` imports JAX, which the card's machine does not have,
so run them there from the root of a checkout without it:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_stem_card.py

Tolerance: the kernel and its plain version (cuDNN's conv, PyTorch's pool)
take the same bf16 operands, whose products are exact, and differ only in
the order of one float32 sum of 147 products before one rounding to bf16.
So each output lies within one bf16 ulp of the plain version's, and of the
same stem with exact (float64) sums, except where the sum cancels to near
zero, where it may lie as far as reordering the float32 sum moves it
(``stem.within_tolerance``).
"""

import numpy as np
import pytest

SEED = 2147623011


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _inputs(batch, dtype, device):
    import torch

    rng = np.random.default_rng(SEED + batch)
    x = rng.normal(0, 1, (batch, 224, 224, 3)).astype(np.float32)
    kernel = rng.normal(0, 0.15, (7, 7, 3, 64)).astype(np.float32)
    bias = rng.normal(0, 1, 64).astype(np.float32)
    return (torch.from_numpy(x).to(device).to(dtype),
            torch.from_numpy(kernel).to(device),
            torch.from_numpy(bias).to(device))


@pytest.mark.card
@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_within_one_ulp(card, batch, dtype):
    """The kernel against its plain version and against the exact sums, at
    the stem's shape."""
    import torch

    from compute_engine_tpu_torch.kernels import stem

    x, kernel, bias = _inputs(batch, getattr(torch, dtype), card)
    launches = stem.stem_conv_pool.launches
    got = stem.stem_conv_pool(x, kernel, bias,
                              filter_bf16=stem.stem_filter(kernel))
    torch.cuda.synchronize()
    assert stem.stem_conv_pool.launches == launches + 1
    assert got.shape == (batch, 56, 56, 64) and got.dtype == torch.bfloat16
    for want in (stem.stem_conv_pool_plain(x, kernel, bias),
                 stem.stem_conv_pool_exact(x, kernel, bias)):
        ok, ulps = stem.within_tolerance(got, want, x, kernel, bias)
        assert bool(ok.all()), (int((~ok).sum()), float(ulps.max()))


@pytest.mark.card
@pytest.mark.parametrize("model, launches", [("birealnet18", 1),
                                             ("binary_densenet45", 1),
                                             ("quicknet", 0)])
def test_stem_launches_a_forward(card, model, launches):
    """A b128 forward through ``Interpreter`` (one CUDA graph) launches
    the stem kernel once in Bi-RealNet-18 and DenseNet-45, never in
    QuickNet."""
    import torch

    from compute_engine_tpu_torch.kernels import stem
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.runtime import Interpreter

    spec = get_model(model)
    interp = Interpreter(spec, convert_model(spec, init_model(spec, seed=0)),
                         output_mode="logits", device=card)
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1, (128, 224, 224, 3)).astype(np.float32)).to(card)
    interp(x).cpu()  # compiles: the capture is not counted
    before = stem.stem_conv_pool.launches
    forwards = 3
    for _ in range(forwards):
        interp(x)
    torch.cuda.synchronize()
    assert stem.stem_conv_pool.launches - before == launches * forwards
