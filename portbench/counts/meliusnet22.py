"""MeliusNet-22's multiply-adds per image, from the configuration's shapes
(224x224x3 input), counted as QuickNet's are (``counts/quicknet.py``):
binary multiply-adds apart from float ones; and the floors of its binary
convs, which the block kernel's zero-padded form runs: all 38
(``residual_blocks``), and of those the 19 improvements, the kernel's tail
form (``improvements``).
"""

from __future__ import annotations


def _layers(config):
    """``(h, w, c_in, improvement)`` of every binary conv, in forward order;
    each writes ``growth_rate`` channels, and an improvement adds them into
    the stream's last ``growth_rate``."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # 3x3/2 stem conv
    h, w = -(-h // 2), -(-w // 2)              # 3x3/2 max pool
    c, g = config["stem_filters"][-1], config["growth_rate"]
    pairs = config["pairs_per_block"]
    out = []
    for b, n in enumerate(pairs):
        for i in range(n):
            out.append((h, w, c + i * g, False))
            out.append((h, w, c + (i + 1) * g, True))
        if b < len(pairs) - 1:
            h, w = h // 2, w // 2              # 2x2/2 max pool
            c = config["transition_filters"][b]
    return out


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # the stem runs at half size
    fl, c = 0, config["channels"]
    for f, groups in zip(config["stem_filters"], config["stem_groups"]):
        fl += h * w * 9 * (c // groups) * f
        c = f
    g = config["growth_rate"]
    binary = sum(h * w * 9 * c * g for h, w, c, _ in _layers(config))
    h, w = h // 2, w // 2                      # 3x3/2 max pool
    c = config["stem_filters"][-1]
    pairs, groups = config["pairs_per_block"], config["transition_groups"]
    for b, n in enumerate(pairs[:-1]):
        h, w = h // 2, w // 2                  # 2x2/2 max pool, then 1x1
        f = config["transition_filters"][b]
        fl += h * w * ((c + n * g) // groups) * f
        c = f
    fl += (c + pairs[-1] * g) * config["num_classes"]
    return {"binary_macs": binary, "float_macs": fl}


def _floor(config, batch, improvements_only):
    """``(launches, floor_s)`` of the binary convs of one forward at
    ``batch`` (the improvements only, or all): the larger of their one-bit
    multiply-adds at the one-bit peak and their bytes at the HBM peak. The
    bytes are the C_in-channel bf16 input read once (an improvement's
    residual, the input's last ``growth_rate`` channels, among them: the
    kernel reads them again for its add, as QuickNet's and Bi-RealNet's
    blocks read theirs, and a byte read again costs the floor nothing), the
    ``growth_rate`` channels written once, the packed filters and the
    (C_out, 9) int32 ``tap_delta`` table of the zero padding once."""
    from portbench import peaks

    g = config["growth_rate"]
    macs = nbytes = launches = 0
    for h, w, c, improvement in _layers(config):
        if improvements_only and not improvement:
            continue
        launches += 1
        macs += batch * h * w * c * g * 9
        nbytes += (batch * h * w * (c + g) * 2
                   + g * 9 * (-(-c // 32)) * 4 + g * 9 * 4)
    return launches, max(macs / peaks.ONE_BIT_MACS,
                         nbytes / peaks.HBM_BYTES)


def residual_blocks(config, batch):
    """``(launches, floor_s)`` of all 38 binary convs of one forward at
    ``batch`` (see ``_floor``)."""
    return _floor(config, batch, improvements_only=False)


def improvements(config, batch):
    """``(launches, floor_s)`` of the 19 improvement blocks of one forward
    at ``batch``, the block kernel's tail form (see ``_floor``)."""
    return _floor(config, batch, improvements_only=True)
