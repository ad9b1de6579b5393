"""The float stem and its max pool in one kernel: a 7x7/2 conv to 64 channels
with its BN folded in, then a 3x3/2 max pool, both SAME.

``stem_conv_pool`` computes

    maxpool_3x3/2_SAME(bf16(act(bf16(x) (*) bf16(kernel) + bias)))

for an NHWC image ``x`` of at most 4 channels and a stride-2 SAME conv
whose K (``stem_k``: KH filter rows of KW * C values, each row padded to an
even length) is at most 160, to 64 channels: Bi-RealNet-18's and the
BinaryDenseNets' stem. On a CUDA tensor it launches the hand-written kernel
in ``csrc/stem_conv_pool.cu``; on a CPU tensor it runs
``stem_conv_pool_plain``, the plain PyTorch version, which is the chain the
packed builder runs for any float conv and max pool (``models.layers``
``conv2d``, the bias, the activation, the store in bf16, ``max_pool``).
It replaces no TPU kernel: the JAX package leaves the conv and the pool to
XLA. It is bound by bytes (the images read once, the pooled stream written
once: 0.038 ms at b128 at 3.35 TB/s); the kernel's source says how its
design keeps every conv output in shared memory.

Rounding: both take bf16 operands, whose products are exact in float32, sum
them in float32, add the bias in float32 and round once to bf16; the max is
exact. Only the order of the float32 sum differs (the kernel's tensor cores
against cuDNN's), so an output of the kernel lies within one bf16 ulp of
the plain version's, and beyond it only where the sum cancels to near zero,
by at most what reordering a float32 sum can move it (``within_tolerance``).

The kernel reads the filter rounded to bf16 and laid out in its K order,
(64, 160) (``stem_filter``), which the model runtime makes once per layer
(``models.prepare_runtime_arrays``) and passes in; a call without it makes
it on the spot. Launches are counted in ``stem_conv_pool.launches``
(``kernels.counts``). Inside ``kernels.debug_checks()`` the kernel's debug
build holds that no operand is read from outside the input patch it staged
(``kernels/debug.py``, bit 16), and the plain version holds the same of the
launch plan.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.params import tflite_same_padding
from . import counts, debug
from .residual import MAX_SHARED_BYTES, SM_COUNT

__all__ = ["stem_conv_pool", "stem_conv_pool_plain", "stem_supported",
           "takes_filter",
           "stem_conv_pool_exact", "stem_filter", "stem_k", "plan_stem",
           "farthest_read", "within_tolerance"]

MAX_K = 160                # K the kernel's filter holds: 10 MMA steps of 16
C_OUT = 64
MAX_CHANNELS = 4
_TILE = (7, 8)             # pooled outputs a block's tile: rows, columns
_ROWS = 256                # rows of a tile's GEMM (255 conv positions)
_FILTER_STRIDE = MAX_K + 8  # shared-memory strides, in bf16 elements
_TILE_STRIDE = C_OUT + 8
_BLOCKS_PER_SM = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTIVATIONS = {None: 0, "NONE": 0, "relu": 1, "relu6": 2}


def stem_k(kh: int, kw: int, c: int) -> int:
    """The kernel's K: KH filter rows of KW * C values, each padded to an
    even length, so that a pair of neighbouring K values lies in one row."""
    return kh * (-(-kw * c // 2) * 2)


def takes_filter(shape) -> bool:
    """Whether the kernel takes a conv kernel of this (KH, KW, C, C_out)
    shape: C <= 4, 64 output channels, ``stem_k`` <= 160."""
    return (len(shape) == 4 and shape[3] == C_OUT
            and shape[2] <= MAX_CHANNELS and stem_k(*shape[:3]) <= MAX_K)


def stem_supported(x, kernel, stride, padding, groups=1, dilation=(1, 1),
                   activation=None) -> bool:
    """Static conditions under which the kernel applies to ``conv(x)``: a
    contiguous (N, H, W, C) float32 or bfloat16 tensor, a kernel it takes
    (``takes_filter``), stride 2, SAME, ungrouped, undilated, and an
    activation the kernel has (none, relu, relu6)."""
    return (isinstance(x, torch.Tensor) and x.dim() == 4
            and x.dtype in _DTYPE_CODES and x.is_contiguous()
            and takes_filter(tuple(kernel.shape))
            and x.shape[-1] == kernel.shape[2]
            and tuple(stride) == (2, 2) and padding == "SAME"
            and groups == 1 and tuple(dilation) == (1, 1)
            and activation in _ACTIVATIONS)


def stem_filter(kernel):
    """The (KH, KW, C, 64) float kernel rounded to bf16 (as the plain chain
    rounds it) and laid out as the kernel reads it: (64, 160), row o holding
    k = ky * KR + kx * C + c, each filter row padded with zeros to an even
    KR, and K with zeros to 160."""
    kh, kw, c, co = kernel.shape
    kr = stem_k(1, kw, c)
    w = kernel.to(torch.bfloat16).reshape(kh, kw * c, co)
    w = torch.nn.functional.pad(w, (0, 0, 0, kr - kw * c)).reshape(kh * kr, co)
    w = torch.nn.functional.pad(w, (0, 0, 0, MAX_K - kh * kr))
    return w.t().contiguous()


def plan_stem(n: int, h: int, w: int, c: int, kh: int, kw: int,
              itemsize: int = 4, sm_count: int = SM_COUNT) -> dict:
    """Launch plan of the kernel for an (n, h, w, c) input of ``itemsize``
    bytes an element and a KH x KW filter: the SAME paddings, the tiles
    (7 x 8 pooled outputs of one image each, from 15 x 17 conv outputs and
    a patch of 2 * 14 + KH input rows, two of each in flight), the
    persistent grid (two blocks an SM, at most one a tile) and the
    shared-memory bytes, laid out as
    ``csrc/stem_conv_pool.cu`` ``shared_bytes`` lays them out. The wrapper
    passes the plan to the kernel's entry, which refuses one that is not
    what its layout needs."""
    hc, pad_top, _ = tflite_same_padding(h, kh, 2, 1)
    wc, pad_left, _ = tflite_same_padding(w, kw, 2, 1)
    ho, pool_top, _ = tflite_same_padding(hc, 3, 2, 1)
    wo, pool_left, _ = tflite_same_padding(wc, 3, 2, 1)
    tph, tpw = _TILE
    tiles = n * -(-ho // tph) * -(-wo // tpw)
    patch_rows = 4 * tph + kh
    patch_elems = (4 * tpw + kw + (kw * c) % 2) * c  # a patch row's values
    row_stride = patch_elems + patch_elems % 2
    e = 16 // itemsize
    chunks = -(-(patch_elems + e - 1) // e)  # 16-byte chunks a staged row
    smem = (2 * C_OUT * _FILTER_STRIDE + 16 * 4 * (MAX_K // 16) + 4 * C_OUT
            + 2 * (-(-2 * patch_rows * row_stride // 16) * 16)
            + 2 * _ROWS * _TILE_STRIDE + 2 * 16 * patch_rows * chunks)
    return {"conv_out": (hc, wc), "pad": (pad_top, pad_left),
            "out": (ho, wo), "pool_pad": (pool_top, pool_left),
            "tiles": tiles,
            "blocks": min(tiles, _BLOCKS_PER_SM * sm_count),
            "patch": (patch_rows, row_stride), "smem_bytes": smem}


def farthest_read(plan, kh, kw, c):
    """The element of the staged patch that the kernel reads farthest in:
    the last conv position of a tile (2 * 14 rows and 2 * 16 pixels into
    the patch) at the last K pair's second value."""
    stride = plan["patch"][1]
    return (2 * (2 * _TILE[0]) * stride + 2 * (2 * _TILE[1]) * c
            + (kh - 1) * stride + stem_k(1, kw, c) - 1)


def _check_patch(plan, kh, kw, c, declared):
    """The kernel's debug invariant on the plan: its farthest read lies
    inside the patch (``declared`` elements, where given, in place of its
    size)."""
    rows, stride = plan["patch"]
    if farthest_read(plan, kh, kw, c) >= (declared or rows * stride):
        debug.raise_for(16)


def stem_conv_pool_plain(x, kernel, bias, stride=(2, 2), activation=None,
                         _debug_patch_elems=None):
    """Plain PyTorch version: the packed builder's chain for a float conv
    and its max pool, in its order: ``conv2d`` of ``x`` rounded to bf16
    (float32 sums of bf16 operands), the bias in float32, the activation,
    the store in bf16, the 3x3/2 SAME max pool. Inside
    ``kernels.debug_checks()`` it also holds the kernel's patch invariant
    on the launch plan (``_debug_patch_elems`` declares a patch size other
    than the plan's, as the kernel's does)."""
    from ..models import layers as L

    debug.require_enabled(_debug_patch_elems=_debug_patch_elems)
    if debug.enabled():
        kh, kw, c, _ = kernel.shape
        _check_patch(plan_stem(*x.shape, kh, kw, x.element_size()), kh, kw,
                     c, _debug_patch_elems)
    y = L.conv2d(x.to(torch.bfloat16), kernel, tuple(stride), "SAME")
    y = L.apply_activation(y + bias, activation).to(torch.bfloat16)
    return L.max_pool(y, (3, 3), (2, 2), "SAME")


def stem_conv_pool_exact(x, kernel, bias):
    """The stem with exact sums, the yardstick of both versions' rounding:
    a float64 conv of the same bf16 operands, the bias in float64, one
    rounding to bf16 (through float32), the max pool. No activation."""
    from ..models import layers as L

    xn = L._same_pad(x.to(torch.bfloat16).double().permute(0, 3, 1, 2),
                     kernel.shape[:2], (2, 2), (1, 1))
    w = kernel.to(torch.bfloat16).double().permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(xn, w, stride=2).permute(0, 2, 3, 1)
    y = (y + bias.double()).to(torch.float32).to(torch.bfloat16)
    return L.max_pool(y.contiguous(), (3, 3), (2, 2), "SAME")


def within_tolerance(got, want, x, kernel, bias):
    """Where the kernel's output ``got`` may lie from ``want``, the plain
    version's or an exact conv's rounded to bf16: one bf16 ulp of
    ``want``, plus what reordering a float32 sum of the K + 1 terms (the
    products and the bias) can move it, 2 (K + 1) 2^-24 times the sum of
    their magnitudes, pooled over each window as the max is. Returns the
    boolean tensor of outputs within it and the tensor of gaps in bf16 ulps
    of ``want``."""
    from ..models import layers as L

    wantf, gotf = want.double(), got.double()
    ulp = torch.exp2(torch.floor(torch.log2(
        wantf.abs().clamp_min(2.0 ** -126))) - 7)
    mags = L.conv2d(x.to(torch.bfloat16).abs(), kernel.to(
        torch.bfloat16).abs().to(torch.float32), (2, 2), "SAME").double()
    mags = L.max_pool(mags + bias.double().abs(), (3, 3), (2, 2), "SAME")
    k = stem_k(*kernel.shape[:3])
    allowed = ulp + 2 * (k + 1) * 2.0 ** -24 * mags
    gap = (gotf - wantf).abs()
    return gap <= allowed, gap / ulp


def _library(debug_build=False):
    from ._build import load

    lib = load("stem_conv_pool", debug_build)
    fn = lib.ce_stem_conv_pool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, kernel, bias, activation, filter_bf16, patch_elems):
    n, h, w, c = x.shape
    kh, kw = kernel.shape[:2]
    if filter_bf16 is None:
        filter_bf16 = stem_filter(kernel)
    if (filter_bf16.shape != (C_OUT, MAX_K)
            or filter_bf16.dtype != torch.bfloat16):
        raise ValueError(f"the stem's filter must be ({C_OUT}, {MAX_K}) "
                         f"bfloat16, not {tuple(filter_bf16.shape)} "
                         f"{filter_bf16.dtype}")
    bias = bias.to(torch.float32)
    for name, t in (("filter", filter_bf16), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias.shape != (C_OUT,):
        raise ValueError(f"bias needs {C_OUT} values, not {tuple(bias.shape)}")
    plan = plan_stem(n, h, w, c, kh, kw, x.element_size())
    if plan["smem_bytes"] > MAX_SHARED_BYTES or n * h * w * c >= 2 ** 31:
        raise ValueError(f"stem {tuple(x.shape)} does not fit the kernel: "
                         f"{plan}")
    out = torch.empty((n, *plan["out"], C_OUT), dtype=torch.bfloat16,
                      device=x.device)
    checked = debug.enabled()
    lib = _library(checked)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # The launch goes to the image's card, whichever is current.
    with torch.cuda.device(x.device):
        if checked:
            debug.begin(lib, stream, declared_bits=patch_elems)
        rc = lib.ce_stem_conv_pool(
            x.data_ptr(), filter_bf16.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, w, c, kh, kw, *plan["pad"],
            *plan["pool_pad"], _ACTIVATIONS[activation],
            _DTYPE_CODES[x.dtype], plan["blocks"], plan["smem_bytes"], stream)
        if rc != 0:
            raise RuntimeError("stem kernel launch failed: "
                               + lib.ce_error_string(rc).decode())
        counts.count(stem_conv_pool)
        if checked:
            debug.end(lib, stream)
    return out


def stem_conv_pool(x, kernel, bias, stride=(2, 2), activation=None,
                   filter_bf16=None, _debug_patch_elems=None):
    """The float stem conv and its 3x3/2 SAME max pool in one kernel.

    Args:
      x: (N, H, W, C) float32 or bfloat16 images, contiguous NHWC, C <= 4.
      kernel: (KH, KW, C, 64) float conv kernel, the BN folded in, with
        ``stem_k(KH, KW, C)`` <= 160.
      bias: (64,) float32, the folded BN's bias.
      stride: the conv's, which must be 2.
      activation: None, "relu" or "relu6", applied before the store.
      filter_bf16: the (64, 160) ``stem_filter(kernel)`` on ``x``'s device;
        made here when not given.

    Returns (N, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64) bfloat16. CPU
    tensors take the plain version; CUDA tensors take the kernel, which
    counts its launches in ``stem_conv_pool.launches`` (under a graph's
    capture, once per replay); inside ``kernels.debug_checks()`` its debug
    build. Anything the kernel does not take raises: there is no fallback.
    ``_debug_patch_elems`` declares a wrong patch size there, on purpose.
    """
    if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPE_CODES:
        raise TypeError("the stem kernel takes float32 or bfloat16 images, "
                        f"not {getattr(x, 'dtype', type(x))}")
    if not stem_supported(x, kernel, stride, "SAME", activation=activation):
        raise ValueError(
            f"stem kernel unsupported for images {tuple(x.shape)} "
            f"(contiguous: {x.is_contiguous()}), kernel "
            f"{tuple(kernel.shape)}, stride {tuple(stride)}, activation "
            f"{activation!r}: it takes C <= {MAX_CHANNELS}, K <= {MAX_K}, "
            f"{C_OUT} output channels, stride 2, contiguous NHWC")
    debug.require_enabled(_debug_patch_elems=_debug_patch_elems)
    if x.device.type == "cpu":
        return stem_conv_pool_plain(x, kernel, bias, stride, activation,
                                    _debug_patch_elems)
    if x.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {x.device}")
    return _launch(x, kernel, bias, activation, filter_bf16,
                   _debug_patch_elems)


stem_conv_pool.launches = 0
