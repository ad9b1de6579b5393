"""Primitive layer math shared by the model builders (NHWC, torch).

Keras semantics as in ``compute_engine_tpu.models.layers``: kernels are
(H, W, I, O), BatchNormalization uses moving statistics, ``ste_sign`` maps
0 to +1. Every public function takes and returns NHWC tensors; convolutions
and pools run on the channels-last NCHW view (``x.permute(0, 3, 1, 2)``),
which needs no copy.

The float convolutions and the dense layer take their operands in the
activation's dtype and accumulate in float32: operands are rounded to
``x.dtype`` and upcast, and the product runs in float32, as JAX's
``preferred_element_type=float32`` does. TF SAME padding is asymmetric (a
3x3/2 conv on 224 pads (0, 1)), so it is applied explicitly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import tflite_same_padding

BN_EPSILON = 1e-5


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """larq ``ste_sign`` forward: +-1 with sign(0) = +1."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _same_pad(x_nchw, ksize, stride, dilation, value=0.0):
    """Pad an NCHW tensor to TF SAME (bottom/right take the odd pixel)."""
    _, pt, pb = tflite_same_padding(x_nchw.shape[2], ksize[0], stride[0],
                                    dilation[0])
    _, pl, pr = tflite_same_padding(x_nchw.shape[3], ksize[1], stride[1],
                                    dilation[1])
    return F.pad(x_nchw, (pl, pr, pt, pb), value=value)


def _as_compute(x, kernel):
    """Operands rounded to ``x.dtype``, then float32 for the product."""
    return (x.to(torch.float32),
            kernel.to(device=x.device, dtype=x.dtype).to(torch.float32))


def conv2d(x, kernel, stride=(1, 1), padding="SAME", groups=1,
           dilation=(1, 1)):
    """Plain conv, kernel (H, W, I, O), NHWC; float32 result."""
    xf, kf = _as_compute(x, kernel)
    xf = _nchw(xf)
    if padding == "SAME":
        xf = _same_pad(xf, kf.shape[:2], stride, dilation)
    y = F.conv2d(xf, kf.permute(3, 2, 0, 1), stride=tuple(stride),
                 dilation=tuple(dilation), groups=groups)
    return _nhwc(y)


def depthwise_conv2d(x, kernel, stride=(1, 1), padding="SAME"):
    """Depthwise conv, kernel (H, W, C, 1) (Keras layout); float32 result."""
    c = x.shape[-1]
    xf, kf = _as_compute(x, kernel)
    xf = _nchw(xf)
    if padding == "SAME":
        xf = _same_pad(xf, kf.shape[:2], stride, (1, 1))
    w = kf.reshape(kf.shape[0], kf.shape[1], c).permute(2, 0, 1)[:, None]
    return _nhwc(F.conv2d(xf, w, stride=tuple(stride), groups=c))


def batch_norm(x, bn_params):
    """Inference-mode BN with moving statistics (Keras semantics)."""
    scale = bn_params["gamma"] * torch.rsqrt(
        bn_params["moving_variance"] + BN_EPSILON)
    return (x - bn_params["moving_mean"]) * scale + bn_params["beta"]


def fold_batch_norm(bn_params):
    """BN -> per-channel (multiplier, bias), host math in float64."""
    gamma = np.asarray(bn_params["gamma"], np.float64)
    beta = np.asarray(bn_params["beta"], np.float64)
    mean = np.asarray(bn_params["moving_mean"], np.float64)
    var = np.asarray(bn_params["moving_variance"], np.float64)
    mul = gamma / np.sqrt(var + BN_EPSILON)
    bias = beta - mean * mul
    return mul.astype(np.float32), bias.astype(np.float32)


def apply_activation(x, activation):
    if activation is None or activation == "NONE":
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "relu6":
        return torch.clamp(x, 0, 6)
    raise ValueError(f"unknown activation {activation!r}")


def max_pool(x, pool_size, stride, padding="SAME"):
    """Max pool; SAME pads with -inf (the dtype's minimum for integers)."""
    xn = _nchw(x)
    if padding == "SAME":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        xn = _same_pad(xn, pool_size, stride, (1, 1), value=low)
    return _nhwc(F.max_pool2d(xn, tuple(pool_size), tuple(stride)))


def avg_pool(x, pool_size, stride, padding="VALID"):
    """Average pool in float32; SAME pads with 0 and still divides by the
    whole window, as XLA's reduce_window sum does."""
    xn = _nchw(x.to(torch.float32))
    if padding == "SAME":
        xn = _same_pad(xn, pool_size, stride, (1, 1))
    return _nhwc(F.avg_pool2d(xn, tuple(pool_size), tuple(stride))).to(x.dtype)


def global_avg_pool(x):
    return x.to(torch.float32).mean(dim=(1, 2))


def dense(x, kernel, bias=None):
    xf, kf = _as_compute(x, kernel)
    y = xf @ kf
    if bias is not None:
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# Initializers (host-side numpy, identical to the JAX package's, so the same
# seed gives the same weights bit for bit)
# ---------------------------------------------------------------------------


def he_normal(rng, shape, fan_in):
    return rng.normal(0.0, float(np.sqrt(2.0 / fan_in)),
                      size=shape).astype(np.float32)


def glorot_uniform(rng, shape, fan_in, fan_out):
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def init_bn(rng, channels, randomize=False):
    """Random moving statistics (``randomize``) make conversion tests
    non-trivial."""
    if randomize:
        return {
            "gamma": rng.uniform(0.2, 1.5, channels).astype(np.float32)
            * rng.choice([-1.0, 1.0], channels).astype(np.float32),
            "beta": rng.normal(0, 0.5, channels).astype(np.float32),
            "moving_mean": rng.normal(0, 1.0, channels).astype(np.float32),
            "moving_variance": rng.uniform(0.5, 2.0,
                                           channels).astype(np.float32),
        }
    return {
        "gamma": np.ones(channels, np.float32),
        "beta": np.zeros(channels, np.float32),
        "moving_mean": np.zeros(channels, np.float32),
        "moving_variance": np.ones(channels, np.float32),
    }
