"""QuickNet, plain PyTorch: the reference of the ``quicknet`` configuration.

Bannink et al., "Larq Compute Engine: Design, Benchmark and Deploy
State-of-the-Art Binarized Neural Networks" (MLSys 2021, arXiv:2011.09398)
and larq-zoo's ``larq_zoo/sota/quicknet.py``, as the configuration file
states it: a float stem (3x3/2 conv to a quarter of the first section's
filters, ReLU; depthwise 3x3/2, ReLU; pointwise 1x1, no activation), then per
section a float transition (2x2/2 max pool, 1x1 conv) before every section
but the first, and residual blocks ``x + BN(bconv3x3(sign(x)))`` with the
binary conv's SAME padding filled with +1 after the sign; ReLU, global
average pool, dense head. Every conv is followed by BN. The forward returns
logits (no softmax). Layer names are those of the parameter tree.
"""

from __future__ import annotations

from portbench.reference import plain as P

__all__ = ["layers", "make_params", "forward"]


def layers(config):
    """``(name, kind, kernel_shape)`` of every layer, in forward order."""
    filters, blocks = config["section_filters"], config["section_blocks"]
    f0 = filters[0]
    out = [("stem_conv", "conv", (3, 3, 3, f0 // 4)),
           ("stem_depthwise", "depthwise", (3, 3, f0 // 4, 1)),
           ("stem_pointwise", "conv", (1, 1, f0 // 4, f0))]
    for s, (f, n) in enumerate(zip(filters, blocks)):
        if s > 0:
            out.append((f"transition_{s}", "conv", (1, 1, filters[s - 1], f)))
        out += [(f"section_{s}_block_{i}", "binary", (3, 3, f, f))
                for i in range(n)]
    out.append(("head", "dense", (filters[-1], config["num_classes"])))
    return out


def make_params(config, seed, device):
    return P.make_params(layers(config), seed, device)


def forward(params, config, x, stream_dtype):
    """Logits (N, classes), float32, of NHWC float32 images ``x``, the
    activation stream held in ``stream_dtype``."""
    rnd = P.Rounder(stream_dtype)
    with P.exact_float32():
        h = x.permute(0, 3, 1, 2)
        h = P.conv(h, params["stem_conv"], 2, rnd, "relu")
        h = P.depthwise(h, params["stem_depthwise"], 2, rnd, "relu")
        h = P.conv(h, params["stem_pointwise"], 1, rnd)
        for s, n in enumerate(config["section_blocks"]):
            if s > 0:
                h = P.max_pool(h, 2, 2)
                h = P.conv(h, params[f"transition_{s}"], 1, rnd)
            for i in range(n):
                y = P.binary_conv(h, params[f"section_{s}_block_{i}"], 1, 1,
                                  rnd)
                h = rnd(h + y)
        h = torch_relu_mean(h)
        return P.dense(h, params["head"], rnd)


def torch_relu_mean(h):
    """ReLU, then the global average over the spatial axes, in float32."""
    return h.clamp(min=0).mean(dim=(2, 3))
