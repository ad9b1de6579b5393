"""Device choice for the port's entry points, and exact float32 on the card.

Entry points run on the card unless the caller asks for another device. With
no card they raise: a run never carries on quietly on the CPU.

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
