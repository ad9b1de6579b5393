"""Device choice for the port's entry points; exact float32 and deterministic
algorithms on the card.

Entry points run on the card unless the caller asks for another device. With
no card they raise: a run never carries on quietly on the CPU.

``deterministic`` makes the card's results a function of the inputs alone
for the length of a call: the JAX package's training is deterministic (XLA
is), while cuDNN's and cuBLAS's fastest backward algorithms add with
atomics in whatever order the threads arrive, so two trainings from one
seed would end in different weights.

``exact_float32`` turns TF32 off for the length of a call. PyTorch lets
cuDNN convolutions run float32 operands through TF32 tensor cores by
default, which rounds each operand to 10 bits of mantissa; the JAX package's
float32 on the CPU, the reference, is exact float32. The float32 forwards,
calibration and training of the port run inside it.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no usable card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return device


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms only inside the block
    (``torch.use_deterministic_algorithms``; cuDNN's deterministic
    algorithms, its autotuner off); an op with no deterministic form raises.
    The caller's settings are restored on the way out, also after an error.

    ``CUBLAS_WORKSPACE_CONFIG`` is set for the block only because torch
    refuses a cuBLAS product under deterministic algorithms without it. It
    does not resize anything: torch sizes a cuBLAS handle's workspace when
    it first creates the handle, so a process that ran a product before
    keeps its workspace (what keeps cuBLAS's sums in order is one stream per
    device). The variable is process-wide: a thread that runs during the
    block sees it too."""
    import os

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        torch.backends.cudnn.benchmark = saved[3]
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and for matrix products inside the block; the
    caller's settings are restored on the way out, also after an error."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
