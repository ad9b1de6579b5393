"""ReActNet-A's multiply-adds per image, from the configuration's shapes
(224x224x3 input), counted as QuickNet's are (``counts/quicknet.py``):
binary multiply-adds apart from float ones; and the floors of its binary
convs that two kernels run: the 9 stride-1 3x3 convs, the block kernel's
ReActNet form with the add and RPReLU (``residual_blocks``), and the 13
1x1 convs, each block's one or its doubling pair as one conv of twice the
width, on the binary GEMM (``pointwise``).
"""

from __future__ import annotations


def _blocks(config):
    """``(h, w, c, c_out, stride)`` of every block: its input's spatial
    size and channels, its output's channels, its 3x3 conv's stride
    (2 where the width changes to other than the first block's)."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # 3x3/2 stem
    c, first = config["stem_filters"], config["block_widths"][0]
    out = []
    for c_out in config["block_widths"]:
        stride = 2 if c_out not in (c, first) else 1
        out.append((h, w, c, c_out, stride))
        h, w, c = -(-h // stride), -(-w // stride), c_out
    return out


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # the stem's output
    fl = h * w * 9 * config["channels"] * config["stem_filters"]
    binary = 0
    for h, w, c, c_out, stride in _blocks(config):
        ho, wo = -(-h // stride), -(-w // stride)
        binary += ho * wo * 9 * c * c + ho * wo * c * c_out
    fl += config["block_widths"][-1] * config["num_classes"]
    return {"binary_macs": binary, "float_macs": fl}


def _floor(macs, nbytes):
    from portbench import peaks

    return max(macs / peaks.ONE_BIT_MACS, nbytes / peaks.HBM_BYTES)


def residual_blocks(config, batch):
    """``(launches, floor_s)`` of the stride-1 3x3 convs of one forward at
    ``batch``, the block kernel's ReActNet form: the larger of their
    one-bit multiply-adds at the one-bit peak and their bytes at the HBM
    peak. The bytes are the bf16 input read once (its add reads it again,
    which costs the floor nothing) and the bf16 output written once, the
    packed filters, the (C, 9) int32 ``tap_delta`` table of the zero
    padding, the C float32 shifts and the 3 C float32 of the RPReLU once."""
    macs = nbytes = launches = 0
    for h, w, c, _, stride in _blocks(config):
        if stride != 1:
            continue
        launches += 1
        macs += batch * h * w * c * c * 9
        nbytes += (2 * batch * h * w * c * 2 + c * 9 * (-(-c // 32)) * 4
                   + c * 9 * 4 + 4 * c * 4)
    return launches, _floor(macs, nbytes)


def pointwise(config, batch):
    """``(launches, floor_s)`` of the 1x1 convs of one forward at
    ``batch``, one launch each (a doubling pair one conv of twice the
    width): the larger of their one-bit multiply-adds at the one-bit peak
    and their bytes at the HBM peak. The bytes are the packed signs of the
    input read once, the bf16 residual (the input) read once, the bf16
    output written once and the packed filters once."""
    macs = nbytes = launches = 0
    for h, w, c, c_out, stride in _blocks(config):
        ho, wo = -(-h // stride), -(-w // stride)
        rows = batch * ho * wo
        launches += 1
        macs += rows * c * c_out
        nbytes += (rows * (-(-c // 32)) * 4 + rows * c * 2
                   + rows * c_out * 2 + c_out * (-(-c // 32)) * 4)
    return launches, _floor(macs, nbytes)
