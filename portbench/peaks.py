"""The data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity, at its
700 W limit), as rates per second.

A multiply-add is two operations. The one-bit MMA (``mma.sync`` with
``.and.popc`` on ``b1`` operands) covers eight times the int8 MMA's K at the
same issue rate, so its multiply-adds are counted at eight times the int8
rate (measured at 8.01x on the card, ``kernels/mma_rate.py``).
"""

HBM_BYTES = 3.35e12
BF16_MACS = 989.4e12 / 2
INT8_MACS = 1979e12 / 2
ONE_BIT_MACS = 8 * INT8_MACS


def floor_s(binary_macs, float_macs):
    """Least seconds for the multiply-adds: one-bit ones at the one-bit
    rate, float ones at the bf16 rate."""
    return binary_macs / ONE_BIT_MACS + float_macs / BF16_MACS
