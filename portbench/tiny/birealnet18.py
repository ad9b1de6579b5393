"""Bi-RealNet-18 cut for the CPU tests: its full widths and depths on
32x32 images, 16 classes."""

from __future__ import annotations

import functools


def tiny(config):
    """``(config, model)``: ``config`` cut to the CPU size, and the port's
    ``ModelSpec`` of the same shape."""
    from compute_engine_tpu_torch.models import zoo

    config.update(input_size=[32, 32], num_classes=16)
    return config, zoo.ModelSpec(
        "birealnet18", functools.partial(zoo.birealnet18, num_classes=16),
        input_size=(32, 32), num_classes=16)
