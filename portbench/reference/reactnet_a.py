"""ReActNet-A, plain PyTorch: the reference of the ``reactnet_a``
configuration.

Liu, Shen, Savvides, Xing, Cheng, "ReActNet: Towards Precise Binary Neural
Networks with Generalized Activation Functions" (ECCV 2020,
arXiv:2003.03488) and the authors' ``mobilenet/reactnet.py``, as the
configuration file states it: a float 3x3/2 stem conv with BN and no
activation, then 13 blocks. A block on ``x`` of C channels is

    o1 = RPReLU(BN(bconv3x3(sign(x + b11))) + r)

with ``r = x`` or, at stride 2, its 2x2/2 average pool, the 3x3 conv's
SAME padding filled with 0 after the sign; then

    o2 = RPReLU(BN(bconv1x1(sign(o1 + b21))) + o1)

where the width stays C, and where it doubles two 1x1 convs of the same
signs, each C wide with its own BN, ``o1`` added to each, side by side on
the channels. ``RPReLU(z) = PReLU(z + shift_in) + shift_out``, each vector
per channel. Global average pool, dense head. The forward returns logits
(no softmax).

The parameter tree holds what ``plain.make_params`` draws for every conv
and the head, and, drawn here from a stream of their own, each binary
conv's input shift (``shift``) and each block conv's RPReLU (``rprelu``:
``shift_in``, ``slope``, ``shift_out``; the 3x3 conv's for ``o1``, the
first 1x1 conv's for ``o2``, over every channel of the block's output). The
two convs of a doubling pair hold one shift, the same tensor.
"""

from __future__ import annotations

import torch

from portbench.reference import plain as P

__all__ = ["layers", "blocks", "make_params", "forward"]

SHIFT_SPREAD = 0.3
SLOPES = (0.05, 0.5)
# The shifts' and RPReLUs' stream: the seed mixed apart from the weights'.
STREAM, MIX = 0x5EAC7, 0x9E3779B97F4A7C15


def blocks(config):
    """``(c_in, c_out, stride)`` of every block: stride 2 where the width
    changes to other than the first block's."""
    c, first = config["stem_filters"], config["block_widths"][0]
    out = []
    for c_out in config["block_widths"]:
        out.append((c, c_out, 2 if c_out not in (c, first) else 1))
        c = c_out
    return out


def layers(config):
    """``(name, kind, kernel_shape)`` of every layer, in forward order."""
    out = [("stem_conv", "conv", (3, 3, config["channels"],
                                  config["stem_filters"]))]
    for i, (c, c_out, _) in enumerate(blocks(config)):
        out.append((f"block_{i}_conv_3x3", "binary", (3, 3, c, c)))
        out.append((f"block_{i}_conv_1x1", "binary", (1, 1, c, c)))
        if c_out != c:
            out.append((f"block_{i}_conv_1x1_b", "binary", (1, 1, c, c)))
    out.append(("head", "dense", (config["block_widths"][-1],
                                  config["num_classes"])))
    return out


def make_params(config, seed, device):
    """``plain.make_params`` of the layers, and the shifts and RPReLUs
    drawn on ``device`` from a stream of their own, returned on the CPU:
    shifts normal with spread ``SHIFT_SPREAD``, slopes uniform in
    ``SLOPES``."""
    params = P.make_params(layers(config), seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ STREAM) * MIX % 2 ** 63)
    sizes = [(c, c_out) for c, c_out, _ in blocks(config)]
    n = sum(2 * c + 2 * c + 2 * c_out for c, c_out in sizes)
    normal = torch.randn(n, generator=gen, device=device).cpu() * SHIFT_SPREAD
    uniform = torch.rand(sum(c + c_out for c, c_out in sizes),
                         generator=gen, device=device).cpu()
    lo, hi = SLOPES
    taken = {"n": 0, "u": 0}

    def draw(key, size):
        pool = normal if key == "n" else uniform
        out = pool[taken[key]:taken[key] + size]
        taken[key] += size
        return out

    for i, (c, c_out) in enumerate(sizes):
        for conv, width in (("conv_3x3", c), ("conv_1x1", c_out)):
            p = params[f"block_{i}_{conv}"]
            p["shift"] = draw("n", c)
            p["rprelu"] = {"shift_in": draw("n", width),
                           "slope": lo + (hi - lo) * draw("u", width),
                           "shift_out": draw("n", width)}
        if c_out != c:
            params[f"block_{i}_conv_1x1_b"]["shift"] = (
                params[f"block_{i}_conv_1x1"]["shift"])
    return params


def _channels(v):
    return v[:, None, None]


def _shifted(h, p):
    """The input of a binary conv plus its shift, in float32."""
    return h + _channels(p["shift"])


def _rprelu(z, p, rnd):
    r = p["rprelu"]
    t = z + _channels(r["shift_in"])
    t = torch.where(t < 0, t * _channels(r["slope"]), t)
    return rnd(t + _channels(r["shift_out"]))


def forward(params, config, x, stream_dtype):
    """Logits (N, classes), float32, of NHWC float32 images ``x``, the
    activation stream held in ``stream_dtype``."""
    rnd = P.Rounder(stream_dtype)
    with P.exact_float32():
        h = P.conv(x.permute(0, 3, 1, 2), params["stem_conv"], 2, rnd)
        for i, (c, c_out, stride) in enumerate(blocks(config)):
            p = params[f"block_{i}_conv_3x3"]
            y = P.binary_conv(_shifted(h, p), p, stride, 0, rnd)
            r = h if stride == 1 else P.avg_pool(h, 2, 2, rnd)
            h = _rprelu(rnd(r + y), p, rnd)
            p = params[f"block_{i}_conv_1x1"]
            pair = [p] + ([params[f"block_{i}_conv_1x1_b"]]
                          if c_out != c else [])
            h = torch.cat([rnd(P.binary_conv(_shifted(h, q), q, 1, 0, rnd)
                               + h) for q in pair], dim=1)
            h = _rprelu(h, p, rnd)
        return P.dense(h.mean(dim=(2, 3)), params["head"], rnd)
