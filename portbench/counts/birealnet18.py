"""Bi-RealNet-18's multiply-adds per image, from the configuration's
shapes (224x224x3 input), counted as QuickNet's are (``counts/
quicknet.py``): binary multiply-adds apart from float ones.
"""

from __future__ import annotations


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    h, w = config["input_size"]
    c0 = config["stem_filters"]
    h1, w1 = -(-h // 2), -(-w // 2)            # 7x7/2 stem
    fl = h1 * w1 * 49 * config["channels"] * c0
    hp, wp = -(-h1 // 2), -(-w1 // 2)          # 3x3/2 max pool
    h, w, c = hp, wp, c0
    binary = 0
    for s, (f, n) in enumerate(zip(config["stage_filters"],
                                   config["stage_blocks"])):
        for i in range(n):
            if s > 0 and i == 0:
                ho, wo = -(-h // 2), -(-w // 2)
                # 2x2/2 average pool and 1x1 conv on the shortcut.
                fl += ho * wo * c * f
            else:
                ho, wo = h, w
            binary += ho * wo * 9 * c * f
            h, w, c = ho, wo, f
    classes = config["num_classes"]
    fl += c * classes
    return {"binary_macs": binary, "float_macs": fl}
