"""Plain PyTorch operations shared by the references, and their weight maker.

Nothing here comes from the program under test: the layers are written from
the published architectures (Keras semantics: NHWC tensors, HWIO kernels,
TensorFlow's SAME padding, BatchNormalization with moving statistics, larq's
``ste_sign`` with sign(0) = +1), and the precision of the activation stream is
the configuration's ``compute_dtype``.

Precision. ``Rounder`` stands for the activation stream's dtype. A float
conv or dense layer takes its input and its kernel (BN folded in, as any
inference engine folds it) rounded to that dtype, multiplies and sums in
float32, adds its bias in float32 and stores its output rounded again. A
binary conv reads the signs of the stored stream, so its +-1 products are
exact; its BN is applied to the exact sums in float64 and the result stored.
Residual adds, pools and the ReLU act on stored values and store their
result. ``Rounder("float32")`` keeps float32 throughout;
``Rounder("float8")`` stores in float8 e4m3 with one scale per tensor (its
absolute maximum at 448), the precision below bfloat16 that the
correctness control uses.

Everything runs with TF32 off (``exact_float32``), set and restored around
the reference alone.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-5
FP8_MAX = 448.0

__all__ = ["Rounder", "exact_float32", "same_pad", "conv", "depthwise",
           "binary_conv", "max_pool", "avg_pool", "dense", "fold_bn",
           "make_params"]


class Rounder:
    """Rounds a float32 tensor to the stream's dtype and back to float32."""

    def __init__(self, dtype):
        if dtype not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown stream dtype {dtype!r}")
        self.dtype = dtype

    def __call__(self, x):
        if self.dtype == "float32":
            return x
        if self.dtype == "float8":
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            q = (x / scale).to(torch.float8_e4m3fn)
            return q.to(torch.float32) * scale
        return x.to(getattr(torch, self.dtype)).to(torch.float32)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matrix products inside the block only."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def same_pad(size, k, stride):
    """TensorFlow SAME padding of one axis: (before, after); the odd pixel
    goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, value=0.0):
    """Pads an NCHW tensor to SAME for a k x k window."""
    top, bottom = same_pad(x.shape[2], k, stride)
    left, right = same_pad(x.shape[3], k, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def fold_bn(bn):
    """BN's inference form as (multiplier, bias) per channel, in float64."""
    g = bn["gamma"].double()
    mul = g / torch.sqrt(bn["moving_variance"].double() + BN_EPSILON)
    return mul, bn["beta"].double() - bn["moving_mean"].double() * mul


def conv(x, p, stride, rnd, activation=None):
    """Float conv + BN (+ ReLU), SAME padding. ``x`` NCHW, stored values;
    ``p`` has an HWIO ``kernel`` and ``bn``."""
    mul, bias = fold_bn(p["bn"])
    k = (p["kernel"].double() * mul).float().to(x.device)
    w = rnd(k).permute(3, 2, 0, 1)
    y = F.conv2d(_pad_same(rnd(x), k.shape[0], stride), w, stride=stride)
    y = y + bias.float().to(x.device)[:, None, None]
    if activation == "relu":
        y = torch.relu(y)
    return rnd(y)


def depthwise(x, p, stride, rnd, activation=None):
    """Depthwise conv (HW C 1 kernel) + BN (+ ReLU), SAME padding."""
    mul, bias = fold_bn(p["bn"])
    k = (p["kernel"][:, :, :, 0].double() * mul).float().to(x.device)
    w = rnd(k).permute(2, 0, 1)[:, None]
    y = F.conv2d(_pad_same(rnd(x), k.shape[0], stride), w, stride=stride,
                 groups=x.shape[1])
    y = y + bias.float().to(x.device)[:, None, None]
    if activation == "relu":
        y = torch.relu(y)
    return rnd(y)


def binary_conv(x, p, stride, pad_value, rnd):
    """sign(x) conv sign(kernel), SAME padding with ``pad_value`` (1 or 0)
    after the sign, then BN; the sums are integers and rounded as such."""
    s = torch.where(x < 0, -1.0, 1.0)
    w = torch.where(p["kernel"] < 0, -1.0, 1.0).to(x.device)
    k = w.shape[0]
    t = torch.round(F.conv2d(_pad_same(s, k, stride, float(pad_value)),
                             w.permute(3, 2, 0, 1), stride=stride))
    mul, bias = fold_bn(p["bn"])
    mul, bias = mul.to(x.device), bias.to(x.device)
    return rnd((t.double() * mul[:, None, None]
                + bias[:, None, None]).float())


def max_pool(x, k, stride):
    """Max pool, SAME padding with -inf."""
    return F.max_pool2d(_pad_same(x, k, stride, float("-inf")), k, stride)


def avg_pool(x, k, stride, rnd):
    """Average pool, SAME padding with 0, always dividing by the window."""
    return rnd(F.avg_pool2d(_pad_same(x, k, stride), k, stride))


def dense(x, p, rnd):
    """Float dense + bias: operands in the stream's dtype, float32 sums;
    the result (logits) stays float32."""
    return rnd(x) @ rnd(p["kernel"].to(x.device)) + p["bias"].to(x.device)


def make_params(layers, seed, device):
    """The float parameter tree of ``layers`` from ``seed``, drawn on
    ``device`` in three large calls and returned on the CPU, float32.

    ``layers`` lists ``(name, kind, kernel_shape)`` in forward order, kind
    one of ``conv``, ``depthwise``, ``binary``, ``dense``. Float kernels are
    He-normal, binary latent kernels uniform in [-1, 1) (only their signs
    count), the dense kernel Glorot-uniform with a zero bias. Every conv's BN
    has random moving statistics: gamma of either sign with magnitude in
    [0.2, 1.5), beta and mean normal, variance in [0.5, 2). A binary conv's
    mean and variance are those of its +-1 sums (mean 0, variance K), drawn
    around them as above, so that every layer's output, and with it every
    sign that a binary layer reads, has spread.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    n_normal = n_uniform = 0
    for _, kind, shape in layers:
        size = math.prod(shape)
        if kind == "dense":
            n_uniform += size
            continue
        channels = shape[2] if kind == "depthwise" else shape[-1]
        if kind == "binary":
            n_uniform += size
        else:
            n_normal += size
        n_normal += 3 * channels
        n_uniform += 2 * channels
    normal = torch.randn(n_normal, generator=gen, device=device).cpu()
    uniform = torch.rand(n_uniform, generator=gen, device=device).cpu()
    taken = {"n": 0, "u": 0}

    def draw(pool, key, shape):
        n = math.prod(shape)
        out = pool[taken[key]:taken[key] + n].reshape(shape)
        taken[key] += n
        return out

    params = {}
    for name, kind, shape in layers:
        if kind == "dense":
            c, units = shape
            limit = math.sqrt(6.0 / (c + units))
            params[name] = {
                "kernel": (draw(uniform, "u", shape) * 2 - 1) * limit,
                "bias": torch.zeros(units)}
            continue
        channels = shape[2] if kind == "depthwise" else shape[-1]
        if kind == "binary":
            kernel = draw(uniform, "u", shape) * 2 - 1
            k = shape[0] * shape[1] * shape[2]
            spread = math.sqrt(k)
        else:
            fan_in = shape[0] * shape[1] * (1 if kind == "depthwise"
                                            else shape[2])
            kernel = draw(normal, "n", shape) * math.sqrt(2.0 / fan_in)
            spread = 1.0
        z = draw(normal, "n", (3, channels))
        u = draw(uniform, "u", (2, channels))
        sign = torch.where(z[2] < 0, -1.0, 1.0)
        params[name] = {"kernel": kernel.contiguous(), "bn": {
            "gamma": (0.2 + 1.3 * u[0]) * sign,
            "beta": 0.5 * z[0],
            "moving_mean": spread * z[1],
            "moving_variance": spread ** 2 * (0.5 + 1.5 * u[1])}}
    return params
