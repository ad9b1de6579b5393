"""Primitive layer math shared by the model builders (NHWC, torch).

Keras semantics as in ``compute_engine_tpu.models.layers``: kernels are
(H, W, I, O), BatchNormalization uses moving statistics, ``ste_sign`` maps
0 to +1 and passes its gradient straight through where ``|x| <= 1``. Every public function takes and returns NHWC tensors; convolutions
and pools run on the channels-last NCHW view (``x.permute(0, 3, 1, 2)``),
which needs no copy.

The float convolutions and the dense layer take their operands in the
activation's dtype and accumulate in float32: operands are rounded to
``x.dtype`` and upcast, and the product runs in float32, as JAX's
``preferred_element_type=float32`` does. TF SAME padding is asymmetric (a
3x3/2 conv on 224 pads (0, 1)), so it is applied explicitly.

The integer layers of the int8 pipeline (``conv2d_int8``,
``depthwise_conv2d_int8``, ``dense_int8``) take int8 operands and return the
exact int32 sums, as JAX's ``preferred_element_type=int32`` does. torch has no
integer convolution on CUDA, and a float convolution there may run in TF32 or
through a transforming algorithm, so none of them goes through ``F.conv2d``:
the conv is an im2col of padded slices and one integer matrix product
(``int_matmul``), the depthwise conv a sum of shifted int32 products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import tflite_same_padding

BN_EPSILON = 1e-5


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x < 0, -1.0, 1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x.abs() <= 1.0, grad, torch.zeros_like(grad))


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """larq ``ste_sign``: +-1 with sign(0) = +1; the gradient is the clipped
    identity (1 where ``|x| <= 1``), which makes the QAT float forward
    trainable."""
    return _SteSign.apply(x)


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
    """Max pool; SAME pads with -inf (the dtype's minimum for integers).

    int8 is pooled as float16, which holds every int8 value exactly: torch's
    CUDA max pool takes floating types only."""
    if x.dtype == torch.int8:
        return max_pool(x.to(torch.float16), pool_size, stride,
                        padding).to(torch.int8)
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
# Exact integer layers (int8 operands, int32 sums)
# ---------------------------------------------------------------------------


def _require_int8(**operands):
    for name, t in operands.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")


def int_matmul(a, b):
    """(M, K) int8 @ (K, N) int8 -> the exact (M, N) int32 product.

    On the CPU the operands are widened and multiplied in int32. On the card
    the product is ``torch._int_mm`` (cuBLASLt, int8 in and int32 out on the
    tensor cores), which takes M > 16 and K and N in multiples of 8: the
    operands are padded with zeros, which add nothing to any sum, and the
    product is cut back. ``b`` is handed over as the transposed view of a
    contiguous (N, K) tensor, the layout the int8 tensor cores read. Sums
    stay far inside int32: K * 127**2 < 2**31 up to K = 133,000.
    """
    _require_int8(a=a, b=b)
    m, k = a.shape
    n = b.shape[1]
    if k * 127 * 127 >= 2 ** 31:
        raise ValueError(f"K = {k} could overflow the int32 sum")
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    mp, kp, np_ = max(m, 32), -(-k // 16) * 16, -(-n // 8) * 8
    if (mp, kp) != (m, k) or not a.is_contiguous():
        padded = a.new_zeros((mp, kp))
        padded[:m, :k] = a
        a = padded
    bt = b.new_zeros((np_, kp))
    bt[:n, :k] = b.t()
    return torch._int_mm(a, bt.t())[:m, :n]


def conv2d_int8(x, kernel, stride=(1, 1), padding="SAME", groups=1,
                dilation=(1, 1)):
    """int8 conv, kernel (H, W, I/groups, O) int8, NHWC int8 in; the exact
    int32 accumulator (N, OH, OW, O) out. SAME pads with 0 (zero point 0)."""
    _require_int8(x=x, kernel=kernel)
    kh, kw, cg, c_out = kernel.shape
    if x.shape[-1] != cg * groups:
        raise ValueError(f"input channels {x.shape[-1]} != {cg} * {groups}")
    (sh, sw), (dh, dw) = stride, dilation
    xn = _nchw(x)
    if padding == "SAME":
        xn = _same_pad(xn, (kh, kw), stride, dilation, value=0)
    xp = xn.permute(0, 2, 3, 1)  # NHWC again, padded
    n = xp.shape[0]
    out_h = (xp.shape[1] - (kh - 1) * dh - 1) // sh + 1
    out_w = (xp.shape[2] - (kw - 1) * dw - 1) // sw + 1
    taps = [xp[:, fy * dh:fy * dh + (out_h - 1) * sh + 1:sh,
               fx * dw:fx * dw + (out_w - 1) * sw + 1:sw, :]
            for fy in range(kh) for fx in range(kw)]
    m = n * out_h * out_w
    opg = c_out // groups
    outs = []
    for g in range(groups):
        # (M, KH*KW*Cg) patches in (tap, channel) order, as the kernel's rows.
        patches = torch.cat([t[..., g * cg:(g + 1) * cg] for t in taps],
                            dim=-1).reshape(m, kh * kw * cg)
        w = kernel[..., g * opg:(g + 1) * opg].reshape(kh * kw * cg, opg)
        outs.append(int_matmul(patches, w))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    return acc.reshape(n, out_h, out_w, c_out)


def depthwise_conv2d_int8(x, kernel, stride=(1, 1), padding="SAME"):
    """int8 depthwise conv, kernel (H, W, C, 1) int8, NHWC int8 in; the exact
    int32 accumulator out: one int32 multiply-add of a shifted slice per tap
    (K = H * W products per output, so nothing can round or overflow)."""
    _require_int8(x=x, kernel=kernel)
    kh, kw, c, _ = kernel.shape
    if x.shape[-1] != c:
        raise ValueError(f"input channels {x.shape[-1]} != kernel's {c}")
    sh, sw = stride
    xn = _nchw(x)
    if padding == "SAME":
        xn = _same_pad(xn, (kh, kw), stride, (1, 1), value=0)
    xp = xn.permute(0, 2, 3, 1)
    out_h = (xp.shape[1] - kh) // sh + 1
    out_w = (xp.shape[2] - kw) // sw + 1
    w = kernel.to(device=x.device, dtype=torch.int32)
    acc = None
    for fy in range(kh):
        for fx in range(kw):
            tap = xp[:, fy:fy + (out_h - 1) * sh + 1:sh,
                     fx:fx + (out_w - 1) * sw + 1:sw, :].to(torch.int32)
            term = tap * w[fy, fx, :, 0]
            acc = term if acc is None else acc.add_(term)
    return acc


def dense_int8(x, kernel):
    """(M, C) int8 @ (C, units) int8 -> exact int32."""
    return int_matmul(x, kernel)


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
