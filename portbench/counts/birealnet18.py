"""Bi-RealNet-18's multiply-adds per image, from the configuration's
shapes (224x224x3 input), counted as QuickNet's are (``counts/
quicknet.py``): binary multiply-adds apart from float ones; and the floor
of its stride-1 blocks, which the block kernel's zero-padded form runs.
"""

from __future__ import annotations


def _blocks(config):
    """``(h, w, c_in, f, stride)`` of every binary conv, in forward order:
    its output's spatial size, its input channels, its filters."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # 7x7/2 stem
    h, w = -(-h // 2), -(-w // 2)              # 3x3/2 max pool
    c = config["stem_filters"]
    out = []
    for s, (f, n) in enumerate(zip(config["stage_filters"],
                                   config["stage_blocks"])):
        for i in range(n):
            stride = 2 if (s > 0 and i == 0) else 1
            h, w = -(-h // stride), -(-w // stride)
            out.append((h, w, c, f, stride))
            c = f
    return out


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    h, w = config["input_size"]
    h1, w1 = -(-h // 2), -(-w // 2)            # 7x7/2 stem
    fl = h1 * w1 * 49 * config["channels"] * config["stem_filters"]
    binary = 0
    for ho, wo, c, f, stride in _blocks(config):
        if stride == 2:
            # 2x2/2 average pool and 1x1 conv on the shortcut.
            fl += ho * wo * c * f
        binary += ho * wo * 9 * c * f
    fl += config["stage_filters"][-1] * config["num_classes"]
    return {"binary_macs": binary, "float_macs": fl}


def residual_blocks(config, batch):
    """``(launches, floor_s)`` of the stride-1 blocks of one forward at
    ``batch``, the block kernel's zero-padded form with the add: the larger
    of their one-bit multiply-adds at the one-bit peak and their bytes at
    the HBM peak. The bytes are QuickNet's (``counts/quicknet.py``: the bf16
    stream read and written once, the packed filters once) and the (C_out,
    9) int32 ``tap_delta`` table of the zero padding once."""
    from portbench import peaks

    macs = nbytes = launches = 0
    for h, w, c, f, stride in _blocks(config):
        if stride != 1:
            continue
        launches += 1
        macs += batch * h * w * c * f * 9
        nbytes += (2 * batch * h * w * f * 2 + f * 9 * (-(-c // 32)) * 4
                   + f * 9 * 4)
    return launches, max(macs / peaks.ONE_BIT_MACS,
                         nbytes / peaks.HBM_BYTES)
