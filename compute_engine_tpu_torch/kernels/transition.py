"""The float transition of the BinaryDenseNets in one kernel: a 1x1 conv
with its BN folded in, then a 2x2/2 VALID average pool.

``transition_conv_pool`` computes

    avg_pool_2x2/2(bf16(bf16(x) . bf16(kernel) + bias))

for an NHWC bf16 stream ``x`` (channel stride 1, any pixel stride: a
channel prefix of the dense block's buffer) of C_in channels, a multiple
of 16, to C_out channels, a multiple of 32 up to 288, at an even height
and width. On a CUDA tensor it launches the hand-written kernel in
``csrc/transition_conv_pool.cu``; on a CPU tensor it runs
``transition_conv_pool_plain``, the plain PyTorch version, which is the
chain the packed builder runs for any float conv and average pool
(``models.layers`` ``conv2d``, the bias, the store in bf16, ``avg_pool``).
It replaces no TPU kernel: the JAX package leaves the conv and the pool to
XLA. It is bound by bytes: DenseNet-45's three transitions at b128 read
603.7 MB of stream once and write 48.6 MB once (653.6 MB with the filters
and biases, 0.195 ms at 3.35 TB/s); the kernel's source says how its
design reads the stream once.

Rounding: both take bf16 operands, whose products are exact in float32,
sum them in float32, add the bias in float32, round each conv output to
bf16, average each window in float32 and round once more to bf16. Only the
order of the conv's float32 sum differs (the kernel's tensor cores against
cuDNN's), so an output of the kernel lies within one bf16 ulp of the plain
version's, and beyond it only where a sum cancels, by at most what
reordering a float32 sum can move it (``within_tolerance``).

The kernel reads the filter rounded to bf16 and laid out as (C_out, C_in)
(``transition_filter``), which the model runtime makes once per transition
(``models.prepare_runtime_arrays``) and passes in; a call without it makes
it on the spot. Launches are counted in ``transition_conv_pool.launches``
(``kernels.counts``). Inside ``kernels.debug_checks()`` the kernel's debug
build holds that no operand is read from outside the tile it staged
(``kernels/debug.py``, bit 64), and the plain version holds the same of the
launch plan.
"""

from __future__ import annotations

import ctypes

import torch

from . import counts, debug
from .residual import MAX_SHARED_BYTES, SM_COUNT, _pixel_stride

__all__ = ["transition_conv_pool", "transition_conv_pool_plain",
           "transition_supported", "takes_filter", "transition_filter",
           "transition_conv_pool_exact", "plan_transition", "farthest_read",
           "within_tolerance", "POOL"]

MAX_C_OUT = 288     # 9 MMA column tiles of 32 a warp row
POOL = ((2, 2), (2, 2), "VALID")  # the average pool: size, stride, padding
_TILE = 32          # pooled outputs a tile
_ROWS = 4 * _TILE   # GEMM rows a tile: the four window positions of each
_CHUNK = 64         # K a stage of the ring: one 128-byte swizzled row
_STAGES = (3, 6)    # the ring's depth: as deep as shared memory holds


def takes_filter(shape) -> bool:
    """Whether the kernel takes a conv kernel of this (KH, KW, C_in, C_out)
    shape: 1x1, C_in a multiple of 16, C_out a multiple of 32 up to 288."""
    return (len(shape) == 4 and tuple(shape[:2]) == (1, 1)
            and shape[2] > 0 and shape[2] % 16 == 0
            and 0 < shape[3] <= MAX_C_OUT and shape[3] % 32 == 0)


def _layout_ok(x) -> bool:
    """A bf16 NHWC tensor whose pixels the kernel reads as whole 16-byte
    words: channel stride 1, a pixel stride (``_pixel_stride``) and a
    start on 16 bytes."""
    try:
        xs = _pixel_stride(x, "x")
    except ValueError:
        return False
    return xs % 8 == 0 and x.data_ptr() % 16 == 0


def transition_supported(x, kernel, stride=(1, 1), groups=1,
                         dilation=(1, 1), activation=None, pool=POOL) -> bool:
    """Static conditions under which the kernel applies to a conv of ``x``
    and the average pool ``pool`` of its output ((size, stride, padding),
    None where no average pool reads the conv): an (N, H, W, C_in)
    bfloat16 tensor with channel stride 1 (dense, or a channel prefix of a
    dense NHWC buffer) at an even H and W, a kernel it takes
    (``takes_filter``) of C_in input channels, stride 1, ungrouped,
    undilated, no activation, and the 2x2/2 VALID pool (``POOL``)."""
    return (pool == POOL and isinstance(x, torch.Tensor) and x.dim() == 4
            and x.dtype == torch.bfloat16
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            and x.numel() > 0 and _layout_ok(x)
            and takes_filter(tuple(kernel.shape))
            and x.shape[-1] == kernel.shape[2]
            and tuple(stride) == (1, 1) and groups == 1
            and tuple(dilation) == (1, 1)
            and activation in (None, "NONE"))


def transition_filter(kernel):
    """The (1, 1, C_in, C_out) float kernel rounded to bf16 (as the plain
    chain rounds it) and laid out as the kernel reads it: (C_out, C_in),
    each output channel's C_in values contiguous."""
    return kernel.reshape(kernel.shape[2], kernel.shape[3]).to(
        torch.bfloat16).t().contiguous()


def plan_transition(n: int, h: int, w: int, c_in: int, c_out: int,
                    sm_count: int = SM_COUNT) -> dict:
    """Launch plan of the kernel for an (n, h, w, c_in) input to c_out
    channels: the tiles (32 pooled outputs each, all c_out channels), the
    chunks of K (64 channels each), the ring's stages (as many, from three
    to six, as shared memory holds), the persistent grid (one block an SM,
    at most one a tile) and the shared-memory bytes, laid out as
    ``csrc/transition_conv_pool.cu`` ``shared_bytes`` lays them out. The
    wrapper passes the plan to the kernel's entry, which refuses one that
    is not what its layout needs."""
    pooled = n * (h // 2) * (w // 2)
    tiles = -(-pooled // _TILE)

    def smem(stages):
        return 1024 + stages * (_ROWS + c_out) * _CHUNK * 2 + 4 * c_out

    stages = max([_STAGES[0]] + [k for k in range(_STAGES[0], _STAGES[1] + 1)
                                 if smem(k) <= MAX_SHARED_BYTES])
    return {"out": (n, h // 2, w // 2, c_out), "tiles": tiles,
            "chunks": -(-c_in // _CHUNK), "stages": stages,
            "blocks": min(tiles, sm_count), "smem_bytes": smem(stages),
            "tile_elems": _ROWS * _CHUNK}


def farthest_read(plan):
    """The element of a stage's input tile that the kernel reads farthest
    in: the last of its 128 rows, at the last of the chunk's 64 channels
    (a chunk past C_in is read whole, its copies filled with zeros)."""
    return (_ROWS - 1) * _CHUNK + _CHUNK - 1


def _check_tile(plan, declared):
    """The kernel's debug invariant on the plan: its farthest read lies
    inside the staged tile (``declared`` elements, where given, in place of
    its size)."""
    if farthest_read(plan) >= (declared or plan["tile_elems"]):
        debug.raise_for(64)


def transition_conv_pool_plain(x, kernel, bias, activation=None,
                               _debug_tile_elems=None):
    """Plain PyTorch version: the packed builder's chain for a float 1x1
    conv and its average pool, in its order: ``conv2d`` of ``x`` rounded to
    bf16 (float32 sums of bf16 operands), the bias in float32, the
    activation, the store in bf16, the 2x2/2 VALID average pool (float32,
    then bf16). Inside ``kernels.debug_checks()`` it also holds the
    kernel's tile invariant on the launch plan (``_debug_tile_elems``
    declares a tile size other than the plan's, as the kernel's does)."""
    from ..models import layers as L

    debug.require_enabled(_debug_tile_elems=_debug_tile_elems)
    if debug.enabled():
        _check_tile(plan_transition(*x.shape, kernel.shape[3]),
                    _debug_tile_elems)
    y = L.conv2d(x.to(torch.bfloat16), kernel, (1, 1), "SAME")
    y = L.apply_activation(y + bias, activation).to(torch.bfloat16)
    return L.avg_pool(y, (2, 2), (2, 2), "VALID")


def _conv_exact(x, kernel, bias=None, magnitudes=False):
    """The 1x1 conv of ``x`` and ``kernel`` rounded to bf16, in float64,
    with ``bias``; with ``magnitudes`` the sum of the absolute terms."""
    n, h, w, c = x.shape
    xb = x.to(torch.bfloat16).double().reshape(-1, c)
    wb = kernel.to(device=x.device, dtype=torch.bfloat16).double().reshape(
        c, -1)
    if magnitudes:
        xb, wb = xb.abs(), wb.abs()
    y = xb @ wb
    if bias is not None:
        b = bias.to(x.device).double()
        y = y + (b.abs() if magnitudes else b)
    return y.reshape(n, h, w, -1)


def transition_conv_pool_exact(x, kernel, bias):
    """The transition with exact sums, the yardstick of both versions'
    rounding: a float64 conv of the same bf16 operands, the bias in
    float64, one rounding to bf16 (through float32), the average pool."""
    from ..models import layers as L

    y = _conv_exact(x, kernel, bias).to(torch.float32).to(torch.bfloat16)
    return L.avg_pool(y, (2, 2), (2, 2), "VALID")


def _ulp(v):
    """One bf16 ulp at the magnitude of each float64 value."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(
        2.0 ** -126))) - 7)


def _pool_sum(v):
    """The sum of each 2x2/2 window of an NHWC float64 tensor."""
    n, h, w, c = v.shape
    return v.reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def within_tolerance(got, want, x, kernel, bias):
    """Where the kernel's output ``got`` may lie from ``want``, the plain
    version's or the exact one's: one bf16 ulp of ``want`` (its last
    rounding), plus a quarter of what each of the window's four conv
    outputs may move: a float32 sum of the C_in + 1 terms reordered moves
    it by up to 2 (C_in + 1) 2^-24 times the sum of their magnitudes, and
    its rounding to bf16 by one ulp more, plus the float32 sum of the
    window. Returns the boolean tensor of outputs within it and the tensor
    of gaps in bf16 ulps of ``want``."""
    wantf, gotf = want.double(), got.double()
    ulp = _ulp(wantf)
    y = _conv_exact(x, kernel, bias)
    moved = 2 * (x.shape[-1] + 1) * 2.0 ** -24 * _conv_exact(
        x, kernel, bias, magnitudes=True)
    per_conv = _ulp(y.abs() + moved) + moved
    window = _pool_sum(per_conv + 2.0 ** -22 * y.abs()) / 4
    allowed = ulp + window
    gap = (gotf - wantf).abs()
    return gap <= allowed, gap / ulp


def _library(debug_build=False):
    from ._build import load

    lib = load("transition_conv_pool", debug_build)
    fn = lib.ce_transition_conv_pool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, kernel, bias, filter_bf16, tile_elems):
    n, h, w, c = x.shape
    c_out = kernel.shape[3]
    if filter_bf16 is None:
        filter_bf16 = transition_filter(kernel)
    if (tuple(filter_bf16.shape) != (c_out, c)
            or filter_bf16.dtype != torch.bfloat16):
        raise ValueError(f"the transition's filter must be ({c_out}, {c}) "
                         f"bfloat16, not {tuple(filter_bf16.shape)} "
                         f"{filter_bf16.dtype}")
    bias = bias.to(torch.float32)
    for name, t in (("filter", filter_bf16), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias needs {c_out} values, not "
                         f"{tuple(bias.shape)}")
    if filter_bf16.data_ptr() % 16:
        raise ValueError("the filter must start on 16 bytes")
    plan = plan_transition(n, h, w, c, c_out)
    if plan["smem_bytes"] > MAX_SHARED_BYTES or n * h * w >= 2 ** 31:
        raise ValueError(f"transition {tuple(x.shape)} -> {c_out} does not "
                         f"fit the kernel: {plan}")
    out = torch.empty(plan["out"], dtype=torch.bfloat16, device=x.device)
    checked = debug.enabled()
    lib = _library(checked)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # The launch goes to the stream's card, whichever is current.
    with torch.cuda.device(x.device):
        if checked:
            debug.begin(lib, stream, declared_bits=tile_elems)
        rc = lib.ce_transition_conv_pool(
            x.data_ptr(), filter_bf16.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, w, c, _pixel_stride(x, "x"), c_out,
            plan["stages"], plan["blocks"], plan["smem_bytes"], stream)
        if rc != 0:
            raise RuntimeError("transition kernel launch failed: "
                               + lib.ce_error_string(rc).decode())
        counts.count(transition_conv_pool)
        if checked:
            debug.end(lib, stream)
    return out


def transition_conv_pool(x, kernel, bias, activation=None, filter_bf16=None,
                         _debug_tile_elems=None):
    """The float 1x1 transition conv and its 2x2/2 VALID average pool in
    one kernel.

    Args:
      x: (N, H, W, C_in) bfloat16 stream, channel stride 1 (dense NHWC or a
        channel prefix of a dense NHWC buffer), H and W even, C_in a
        multiple of 16.
      kernel: (1, 1, C_in, C_out) float conv kernel, the BN folded in, C_out
        a multiple of 32 up to 288.
      bias: (C_out,) float32, the folded BN's bias.
      activation: must be None: the transitions have none.
      filter_bf16: the (C_out, C_in) ``transition_filter(kernel)`` on
        ``x``'s device; made here when not given.

    Returns (N, H/2, W/2, C_out) bfloat16, contiguous. CPU tensors take the
    plain version; CUDA tensors take the kernel, which counts its launches
    in ``transition_conv_pool.launches`` (under a graph's capture, once per
    replay); inside ``kernels.debug_checks()`` its debug build. Anything the
    kernel does not take raises: there is no fallback.
    ``_debug_tile_elems`` declares a wrong tile size there, on purpose.
    """
    if not isinstance(x, torch.Tensor) or x.dtype != torch.bfloat16:
        raise TypeError("the transition kernel takes a bfloat16 stream, not "
                        f"{getattr(x, 'dtype', type(x))}")
    if not transition_supported(x, kernel, activation=activation):
        raise ValueError(
            f"transition kernel unsupported for a stream {tuple(x.shape)} "
            f"(strides {x.stride()}), kernel {tuple(kernel.shape)}, "
            f"activation {activation!r}: it takes a 1x1 kernel, C_in a "
            f"multiple of 16, C_out a multiple of 32 up to {MAX_C_OUT}, even "
            "H and W, channel stride 1 and 16-byte pixels, no activation")
    debug.require_enabled(_debug_tile_elems=_debug_tile_elems)
    if x.device.type == "cpu":
        return transition_conv_pool_plain(x, kernel, bias, activation,
                                          _debug_tile_elems)
    if x.device.type != "cuda":
        raise ValueError(f"no transition kernel for device {x.device}")
    return _launch(x, kernel, bias, filter_bf16, _debug_tile_elems)


transition_conv_pool.launches = 0
