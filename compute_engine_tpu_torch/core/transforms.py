"""Output-transform math: accumulator -> final value.

The converter-time fusion (``fuse_output_transform``,
``compute_output_thresholds``) is host math in float64 on numpy, copied from
``compute_engine_tpu.core.transforms`` (LCE ``tflite/kernels/bconv2d.cc:
353-389`` and ``mlir/transforms/optimize.cc:128-188``). The application on
accumulators is torch.

  accum        xor-popcount accumulator in {0..K}, K = FH*FW*C_in_per_group
  float out    float(clamp'(2*accum)) * mul' + bias'
  int8 out     saturate(round_half_away(float out))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bitpack import bitpack
from .types import Activation, round_half_away, saturate_int8

INT32_MIN = np.int32(np.iinfo(np.int32).min)
INT32_MAX = np.int32(np.iinfo(np.int32).max)


def nominal_activation_range(activation: Activation):
    """Clamp range of the fused activation in the conceptual (-K..K)
    domain (TFLite ``CalculateActivationRange``)."""
    if activation == Activation.RELU:
        return 0, int(INT32_MAX)
    if activation == Activation.RELU_N1_TO_1:
        return -1, 1
    if activation == Activation.RELU6:
        return 0, 6
    return int(INT32_MIN), int(INT32_MAX)


@dataclasses.dataclass(frozen=True)
class OutputTransform:
    """Parameters mapping int32 accumulators to the final output: either
    (multiplier, bias) for float/int8 output or thresholds for bitpacked
    output. Arrays are numpy or torch, one value per output channel."""

    clamp_min: int = int(INT32_MIN)
    clamp_max: int = int(INT32_MAX)
    multiplier: object = None  # float32 [C_out]
    bias: object = None        # float32 [C_out]
    thresholds: object = None  # int32 [C_out]


def fuse_output_transform(
    post_activation_multiplier,
    post_activation_bias,
    backtransform_add: int,
    activation: Activation = Activation.NONE,
    output_scale: float | None = None,
    output_zero_point: int = 0,
) -> OutputTransform:
    """Fold the back-transform (and optional int8 requantisation) into
    mul'/bias':

      mul'  = -post_mul / scale
      bias' = (post_bias + K * post_mul) / scale + zero_point
      clamp'_min = -nominal_clamp_max + K,  clamp'_max = -nominal_clamp_min + K
    """
    post_mul = np.asarray(post_activation_multiplier, np.float64)
    post_bias = np.asarray(post_activation_bias, np.float64)
    k = float(backtransform_add)
    scale = 1.0 if output_scale is None else float(output_scale)
    zp = 0.0 if output_scale is None else float(output_zero_point)

    multiplier = (-1.0 * post_mul / scale).astype(np.float32)
    bias = ((post_bias + k * post_mul) / scale + zp).astype(np.float32)

    nominal_min, nominal_max = nominal_activation_range(activation)
    nominal_min = max(nominal_min, -backtransform_add)
    nominal_max = min(nominal_max, backtransform_add)
    return OutputTransform(
        clamp_min=-nominal_max + backtransform_add,
        clamp_max=-nominal_min + backtransform_add,
        multiplier=multiplier,
        bias=bias,
    )


def compute_output_thresholds(
    post_activation_multiplier,
    post_activation_bias,
    backtransform_add: int,
    activation: Activation = Activation.NONE,
) -> np.ndarray:
    """Per-channel int32 thresholds for bitpacked output: a 1-bit is
    written iff ``accum > threshold``. The filter must be pre-multiplied by
    ``sign(post_activation_multiplier)`` per output channel."""
    mult = np.asarray(post_activation_multiplier, np.float32)
    bias = np.asarray(post_activation_bias, np.float32)
    k = int(backtransform_add)
    clamp_min, clamp_max = nominal_activation_range(activation)
    clamp_min = max(clamp_min, -k)
    clamp_max = min(clamp_max, k)

    out = np.empty(mult.shape, np.int32)
    for i in range(mult.size):
        m, b = float(mult.flat[i]), float(bias.flat[i])
        if m == 0.0:
            out.flat[i] = INT32_MIN if b < 0.0 else INT32_MAX
            continue
        eff_min, eff_max = ((clamp_min, clamp_max) if m > 0
                            else (-clamp_max, -clamp_min))
        range_start = eff_min * abs(m) + b
        range_end = eff_max * abs(m) + b
        if range_start < 0 and range_end < 0:
            out.flat[i] = INT32_MIN  # always write a 1-bit
        elif range_start >= 0 and range_end >= 0:
            out.flat[i] = INT32_MAX  # always write a 0-bit
        else:
            out.flat[i] = np.int32(np.floor(0.5 * (b / abs(m) + k)))
    return out


def _channel_vector(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def apply_output_transform_float(accum: torch.Tensor,
                                 transform: OutputTransform) -> torch.Tensor:
    """``float(clamp'(2*accum)) * mul' + bias'`` on int32 ``[..., C]``.

    The product and the sum are two eager ops, so each rounds once: no FMA.
    """
    x = torch.clamp(accum.to(torch.int32) * 2, transform.clamp_min,
                    transform.clamp_max)
    return (x.to(torch.float32) * _channel_vector(transform.multiplier, x)
            + _channel_vector(transform.bias, x))


def apply_output_transform_int8(accum: torch.Tensor,
                                transform: OutputTransform) -> torch.Tensor:
    """Float transform, round half away from zero, saturate to int8."""
    y = apply_output_transform_float(accum, transform)
    return saturate_int8(round_half_away(y).to(torch.int32))


def apply_output_transform_bitpacked(accum: torch.Tensor,
                                     transform: OutputTransform
                                     ) -> torch.Tensor:
    """``accum > threshold``, packed LSB-first along the channel axis with
    padding bits 0 (LCE ``core/bconv2d/output_transform.h:164-167``)."""
    thr = torch.as_tensor(transform.thresholds, dtype=torch.int32,
                          device=accum.device)
    return bitpack(accum > thr)
