"""BinaryDenseNet-45's multiply-adds per image, from the configuration's
shapes (224x224x3 input), counted as QuickNet's are (``counts/
quicknet.py``): binary multiply-adds apart from float ones; the floor of
its dense layers, which the block kernel runs without a residual add; and
the bytes of the concatenations that grow the stream.
"""

from __future__ import annotations


def _blocks(config):
    """``(h, w, c_in, n_layers, c_next)`` of every dense block: its spatial
    size, the stream's channels as it starts, its layers, and the channels
    its transition reduces the stream to (the head's input after the last
    block)."""
    h, w = config["input_size"]
    h, w = -(-h // 2), -(-w // 2)              # 7x7/2 stem
    h, w = -(-h // 2), -(-w // 2)              # 3x3/2 max pool
    c, g = config["initial_filters"], config["growth_rate"]
    n_blocks = len(config["layers_per_block"])
    out = []
    for b, n in enumerate(config["layers_per_block"]):
        end = c + n * g
        if b < n_blocks - 1:
            nxt = int(end // config["reductions"][b] // 32) * 32
        else:
            nxt = end
        out.append((h, w, c, n, nxt))
        h, w, c = h // 2, w // 2, nxt          # 2x2/2 average pool (VALID)
    return out


def _layers(config):
    """``(h, w, c_in)`` of every dense layer's binary conv, in forward
    order; each writes ``growth_rate`` channels."""
    g = config["growth_rate"]
    return [(h, w, c + i * g) for h, w, c, n, _ in _blocks(config)
            for i in range(n)]


def per_image(config):
    """``{"binary_macs", "float_macs"}`` of one image's forward."""
    h, w = config["input_size"]
    h1, w1 = -(-h // 2), -(-w // 2)            # 7x7/2 stem
    fl = h1 * w1 * 49 * config["channels"] * config["initial_filters"]
    g = config["growth_rate"]
    binary = sum(h * w * 9 * c * g for h, w, c in _layers(config))
    blocks = _blocks(config)
    for h, w, c, n, nxt in blocks[:-1]:
        fl += h * w * (c + n * g) * nxt        # 1x1 transition conv
    fl += blocks[-1][-1] * config["num_classes"]
    return {"binary_macs": binary, "float_macs": fl}


def residual_blocks(config, batch):
    """``(launches, floor_s)`` of the dense layers of one forward at
    ``batch``, the block kernel's one-padded form without the add: the
    larger of their one-bit multiply-adds at the one-bit peak and their
    bytes at the HBM peak. The bytes are the C_in-channel bf16 input read
    once, the ``growth_rate`` channels written once and the packed filters
    once; there is no residual to read."""
    from portbench import peaks

    g = config["growth_rate"]
    macs = nbytes = launches = 0
    for h, w, c in _layers(config):
        launches += 1
        macs += batch * h * w * c * g * 9
        nbytes += (batch * h * w * (c + g) * 2
                   + g * 9 * (-(-c // 32)) * 4)
    return launches, max(macs / peaks.ONE_BIT_MACS,
                         nbytes / peaks.HBM_BYTES)


def concats(config, batch):
    """``(launches, bytes)`` of the concatenations of one forward at
    ``batch``: one a dense layer, each reading the bf16 stream and the new
    channels and writing both into a new tensor."""
    g = config["growth_rate"]
    layers = _layers(config)
    return len(layers), sum(2 * batch * h * w * (c + g) * 2
                            for h, w, c in layers)
