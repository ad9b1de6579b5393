"""BinaryDenseNet-45, plain PyTorch: the reference of the
``binary_densenet45`` configuration.

Bethge et al., "BinaryDenseNet: Developing an Architecture for Binary
Neural Networks" (ICCV Workshops 2019) and larq-zoo's
``larq_zoo/literature/densenet.py``, as the configuration file states it: a
float 7x7/2 stem conv with BN and no activation, a 3x3/2 max pool, then four
dense blocks. A dense layer is ``BN(bconv3x3(sign(h)))``, its binary conv's
SAME padding filled with +1 after the sign, giving ``growth_rate`` new
channels that are concatenated onto the stream ``h``. Between blocks a float
transition: a 1x1 conv with BN to ``floor(C / reduction / 32) * 32``
channels, then a 2x2/2 average pool. ReLU, global average pool, dense head.
The forward returns logits (no softmax).
"""

from __future__ import annotations

import torch

from portbench.reference import plain as P

__all__ = ["layers", "make_params", "forward"]


def _stream(config):
    """``(c_in, n_layers, c_out)`` of every dense block: the stream's
    channels as the block starts, its layers, and the channels after the
    block's transition (after the last block, the head's input)."""
    c, g = config["initial_filters"], config["growth_rate"]
    out = []
    blocks = config["layers_per_block"]
    for b, n in enumerate(blocks):
        end = c + n * g
        nxt = (int(end // config["reductions"][b] // 32) * 32
               if b < len(blocks) - 1 else end)
        out.append((c, n, nxt))
        c = nxt
    return out


def layers(config):
    """``(name, kind, kernel_shape)`` of every layer, in forward order."""
    g = config["growth_rate"]
    out = [("stem_conv", "conv", (7, 7, config["channels"],
                                  config["initial_filters"]))]
    blocks = _stream(config)
    for b, (c, n, nxt) in enumerate(blocks):
        out += [(f"block_{b}_layer_{i}", "binary", (3, 3, c + i * g, g))
                for i in range(n)]
        if b < len(blocks) - 1:
            out.append((f"transition_{b}", "conv", (1, 1, c + n * g, nxt)))
    out.append(("head", "dense", (blocks[-1][2], config["num_classes"])))
    return out


def make_params(config, seed, device):
    return P.make_params(layers(config), seed, device)


def forward(params, config, x, stream_dtype):
    """Logits (N, classes), float32, of NHWC float32 images ``x``, the
    activation stream held in ``stream_dtype``."""
    rnd = P.Rounder(stream_dtype)
    blocks = _stream(config)
    with P.exact_float32():
        h = x.permute(0, 3, 1, 2)
        h = P.conv(h, params["stem_conv"], 2, rnd)
        h = P.max_pool(h, 3, 2)
        for b, (_, n, _) in enumerate(blocks):
            for i in range(n):
                y = P.binary_conv(h, params[f"block_{b}_layer_{i}"], 1, 1,
                                  rnd)
                h = torch.cat([h, y], dim=1)
            if b < len(blocks) - 1:
                h = P.conv(h, params[f"transition_{b}"], 1, rnd)
                h = P.avg_pool(h, 2, 2, rnd)
        h = h.clamp(min=0).mean(dim=(2, 3))
        return P.dense(h, params["head"], rnd)
