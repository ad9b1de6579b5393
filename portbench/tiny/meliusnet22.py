"""MeliusNet-22 cut for the CPU tests: its full widths and depths on 32x32
images (the stream reaches 1x1 in the last block), 16 classes."""

from __future__ import annotations

import functools


def tiny(config):
    """``(config, model)``: ``config`` cut to the CPU size, and the port's
    ``ModelSpec`` of the same shape."""
    from compute_engine_tpu_torch.models import zoo

    config.update(input_size=[32, 32], num_classes=16)
    return config, zoo.ModelSpec(
        "meliusnet22", functools.partial(zoo.meliusnet22, num_classes=16),
        input_size=(32, 32), num_classes=16)
