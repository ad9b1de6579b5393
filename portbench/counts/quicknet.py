"""QuickNet's multiply-adds per image, from the configuration's shapes
(224x224x3 input), and the floor of its binary residual blocks.

The multiply-adds are those of ``compute_engine_tpu_torch/scripts/
section_profile.py`` ``floors``, binary ones apart from float ones; the
blocks' bytes count the bf16 stream read and written once and the packed
filters once.
"""

from __future__ import annotations


def _sizes(config):
    h, w = config["input_size"]
    # 3x3/2 conv then depthwise 3x3/2 (SAME): /2 twice, rounded up.
    h1, w1 = -(-h // 2), -(-w // 2)
    h2, w2 = -(-h1 // 2), -(-w1 // 2)
    return (h, w), (h1, w1), (h2, w2)


def sections(config):
    """``(hw, filters, blocks)`` per section: its spatial size (h, w)."""
    _, _, (h, w) = _sizes(config)
    out = []
    for s, (f, n) in enumerate(zip(config["section_filters"],
                                   config["section_blocks"])):
        if s > 0:
            h, w = -(-h // 2), -(-w // 2)
        out.append(((h, w), f, n))
    return out


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    _, (h1, w1), (h2, w2) = _sizes(config)
    f0 = config["section_filters"][0]
    c_stem = f0 // 4
    fl = h1 * w1 * 9 * config["channels"] * c_stem          # stem conv
    fl += h2 * w2 * 9 * c_stem                              # depthwise
    fl += h2 * w2 * c_stem * f0                             # pointwise
    binary, prev = 0, None
    for (h, w), f, n in sections(config):
        if prev is not None:
            fl += h * w * prev * f                          # transition
        binary += n * h * w * f * f * 9
        prev = f
    fl += prev * config["num_classes"]                      # head
    return {"binary_macs": binary, "float_macs": fl}


def residual_blocks(config, batch):
    """``(launches, floor_s)`` of the binary residual blocks of one forward
    at ``batch``: the larger of their one-bit multiply-adds at the one-bit
    peak and their bytes (the bf16 stream read and written once, the packed
    filters once) at the HBM peak."""
    from portbench import peaks

    macs = nbytes = launches = 0
    for (h, w), f, n in sections(config):
        launches += n
        macs += n * batch * h * w * f * f * 9
        nbytes += n * (2 * batch * h * w * f * 2 + f * 9 * (-(-f // 32)) * 4)
    return launches, max(macs / peaks.ONE_BIT_MACS,
                         nbytes / peaks.HBM_BYTES)
