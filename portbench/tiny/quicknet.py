"""QuickNet cut for the CPU tests: sections of 32 and 64 filters, one block
each, 32x32 images, 16 classes, through the port's ``zoo.tiny_quicknet``."""

from __future__ import annotations


def tiny(config):
    """``(config, model)``: ``config`` cut to the CPU size, and the port's
    ``ModelSpec`` of the same shape."""
    from compute_engine_tpu_torch.models import zoo

    config.update(section_filters=[32, 64], section_blocks=[1, 1],
                  input_size=[32, 32], num_classes=16)
    return config, zoo.tiny_quicknet((32, 64), (1, 1), 16, 32)
