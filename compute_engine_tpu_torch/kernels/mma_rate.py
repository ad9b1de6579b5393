"""Rate of the tensor cores at a binary dot product on the card.

``mma_rate`` launches the loop in ``csrc/mma_rate.cu`` and returns binary
multiply-adds per second. It is a measurement, not part of any forward:
``chip_smoke.py`` prints it. The choice of the one-bit MMA in
``csrc/bgemm.cu`` and ``csrc/residual_block.cu`` rests on it, and so does
the one-bit peak that the kernels' bound is reckoned against (eight times
the int8 peak: the two MMAs issue at the same rate).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["mma_rate", "KINDS"]

# name -> (kind code, bits of K one MMA covers)
KINDS = {
    "int8 mma.sync m16n8k32, registers only": (0, 32),
    "one-bit mma.sync m16n8k256 and.popc, registers only": (1, 256),
    "one-bit route: 64x64 warp tile, words from shared memory": (2, 256),
}


def mma_rate(kind: str, iters: int = 2000) -> float:
    """Binary multiply-adds per second of one launch of loop ``kind`` (a key
    of ``KINDS``) on the current CUDA device: one block of 8 warps an SM,
    ``iters`` steps of 32 MMAs in each warp."""
    from ._build import load

    code, k_bits = KINDS[kind]
    lib = load("mma_rate")
    fn = lib.ce_mma_rate
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda", torch.cuda.current_device())
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    ms = ctypes.c_float()
    rc = fn(code, iters, blocks, sink.data_ptr(), ctypes.byref(ms),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("mma_rate launch failed: "
                           + lib.ce_error_string(rc).decode())
    macs = blocks * 8 * iters * 32 * 16 * 8 * k_bits
    return macs / (ms.value * 1e-3)
