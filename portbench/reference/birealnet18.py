"""Bi-RealNet-18, plain PyTorch: the reference of the ``birealnet18``
configuration.

Liu et al., "Bi-Real Net: Enhancing the Performance of 1-bit CNNs with
Improved Representational Capability and Advanced Training Algorithm"
(ECCV 2018, arXiv:1808.00278) and larq-zoo's
``larq_zoo/literature/birealnet.py``, as the configuration file states it: a
float 7x7/2 stem conv with BN and no activation, a 3x3/2 max pool, then four
stages of four blocks ``shortcut + BN(bconv3x3(sign(x)))`` whose binary
conv's SAME padding is zero after the sign; the first block of every stage
but the first has stride 2 and a float shortcut (2x2/2 average pool, 1x1
conv, BN), the others the identity. Global average pool, dense head. The
forward returns logits (no softmax).
"""

from __future__ import annotations

from portbench.reference import plain as P

__all__ = ["layers", "make_params", "forward"]


def layers(config):
    """``(name, kind, kernel_shape)`` of every layer, in forward order."""
    filters, blocks = config["stage_filters"], config["stage_blocks"]
    out = [("stem_conv", "conv", (7, 7, 3, config["stem_filters"]))]
    c = config["stem_filters"]
    for s, (f, n) in enumerate(zip(filters, blocks)):
        for i in range(n):
            if s > 0 and i == 0:
                out.append((f"shortcut_{s}", "conv", (1, 1, c, f)))
            out.append((f"stage_{s}_block_{i}", "binary", (3, 3, c, f)))
            c = f
    out.append(("head", "dense", (c, config["num_classes"])))
    return out


def make_params(config, seed, device):
    return P.make_params(layers(config), seed, device)


def forward(params, config, x, stream_dtype):
    """Logits (N, classes), float32, of NHWC float32 images ``x``, the
    activation stream held in ``stream_dtype``."""
    rnd = P.Rounder(stream_dtype)
    with P.exact_float32():
        h = x.permute(0, 3, 1, 2)
        h = P.conv(h, params["stem_conv"], 2, rnd)
        h = P.max_pool(h, 3, 2)
        for s, n in enumerate(config["stage_blocks"]):
            for i in range(n):
                stride = 2 if (s > 0 and i == 0) else 1
                if stride == 2:
                    shortcut = P.avg_pool(h, 2, 2, rnd)
                    shortcut = P.conv(shortcut, params[f"shortcut_{s}"], 1,
                                      rnd)
                else:
                    shortcut = h
                y = P.binary_conv(h, params[f"stage_{s}_block_{i}"], stride,
                                  0, rnd)
                h = rnd(shortcut + y)
        return P.dense(h.mean(dim=(2, 3)), params["head"], rnd)
