"""MeliusNet-22, plain PyTorch: the reference of the ``meliusnet22``
configuration.

Bethge, Bartz, Yang, Meinel, "MeliusNet: Can Binary Neural Networks Achieve
MobileNet-level Accuracy?" (arXiv:2001.05936) and larq-zoo's
``larq_zoo/literature/meliusnet.py``, as the configuration file states it: a
stem of three float 3x3 convs with BN (the first stride 2, the second in 4
groups and the third in 8; ReLU after the first two), a 3x3/2 max pool, then
four blocks of (dense, improvement) pairs. A dense block is
``BN(bconv3x3(sign(h)))``, its binary conv's SAME padding filled with 0
after the sign, giving ``growth_rate`` new channels concatenated onto the
stream ``h``; an improvement block is the same conv of the whole stream,
added into the stream's last ``growth_rate`` channels. Between blocks a
transition: a 2x2/2 max pool, ReLU, a float 1x1 conv in groups with BN.
ReLU, global average pool, dense head. The forward returns logits (no
softmax).

A grouped conv is one ``plain.conv`` per group over its slice of the
stream, the kernel and the BN.
"""

from __future__ import annotations

import torch

from portbench.reference import plain as P

__all__ = ["layers", "make_params", "forward"]


def _stream(config):
    """``(c_in, n_pairs, c_out)`` of every block: the stream's channels as
    the block starts, its pairs, and the channels its transition gives
    (after the last block, the head's input)."""
    c, g = config["stem_filters"][-1], config["growth_rate"]
    pairs = config["pairs_per_block"]
    out = []
    for b, n in enumerate(pairs):
        nxt = (config["transition_filters"][b] if b < len(pairs) - 1
               else c + n * g)
        out.append((c, n, nxt))
        c = nxt
    return out


def layers(config):
    """``(name, kind, kernel_shape)`` of every layer, in forward order; a
    grouped conv's kernel holds its input channels per group."""
    g = config["growth_rate"]
    out, c = [], config["channels"]
    for i, (f, groups) in enumerate(zip(config["stem_filters"],
                                        config["stem_groups"])):
        out.append((f"stem_conv_{i}", "conv", (3, 3, c // groups, f)))
        c = f
    blocks = _stream(config)
    for b, (c, n, nxt) in enumerate(blocks):
        for i in range(n):
            out.append((f"block_{b}_dense_{i}", "binary",
                        (3, 3, c + i * g, g)))
            out.append((f"block_{b}_improvement_{i}", "binary",
                        (3, 3, c + (i + 1) * g, g)))
        if b < len(blocks) - 1:
            out.append((f"transition_{b}", "conv",
                        (1, 1, (c + n * g) // config["transition_groups"],
                         nxt)))
    out.append(("head", "dense", (blocks[-1][2], config["num_classes"])))
    return out


def make_params(config, seed, device):
    return P.make_params(layers(config), seed, device)


def _slice(p, lo, hi):
    """The parameters of output channels ``lo:hi`` of a conv."""
    return {"kernel": p["kernel"][..., lo:hi],
            "bn": {k: v[lo:hi] for k, v in p["bn"].items()}}


def grouped_conv(x, p, stride, groups, rnd, activation=None):
    """A float conv in ``groups`` groups: one ``P.conv`` per group over its
    slice of ``x``'s channels, of the kernel and of the BN."""
    cg, og = x.shape[1] // groups, p["kernel"].shape[-1] // groups
    return torch.cat([P.conv(x[:, j * cg:(j + 1) * cg],
                             _slice(p, j * og, (j + 1) * og), stride, rnd,
                             activation)
                      for j in range(groups)], dim=1)


def forward(params, config, x, stream_dtype):
    """Logits (N, classes), float32, of NHWC float32 images ``x``, the
    activation stream held in ``stream_dtype``."""
    rnd = P.Rounder(stream_dtype)
    g = config["growth_rate"]
    blocks = _stream(config)
    with P.exact_float32():
        h = x.permute(0, 3, 1, 2)
        last = len(config["stem_filters"]) - 1
        for i, groups in enumerate(config["stem_groups"]):
            h = grouped_conv(h, params[f"stem_conv_{i}"], 2 if i == 0 else 1,
                             groups, rnd, None if i == last else "relu")
        h = P.max_pool(h, 3, 2)
        for b, (_, n, _) in enumerate(blocks):
            for i in range(n):
                y = P.binary_conv(h, params[f"block_{b}_dense_{i}"], 1, 0,
                                  rnd)
                h = torch.cat([h, y], dim=1)
                y = P.binary_conv(h, params[f"block_{b}_improvement_{i}"],
                                  1, 0, rnd)
                h = torch.cat([h[:, :-g], rnd(h[:, -g:] + y)], dim=1)
            if b < len(blocks) - 1:
                h = P.max_pool(h, 2, 2).clamp(min=0)
                h = grouped_conv(h, params[f"transition_{b}"], 1,
                                 config["transition_groups"], rnd)
        h = h.clamp(min=0).mean(dim=(2, 3))
        return P.dense(h, params["head"], rnd)
