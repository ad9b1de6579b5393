"""The benchmark's images, made on the device from a generator.

Each image has a colour of its own, a low-frequency pattern (a 7x7 grid of
random values, bilinearly upsampled) and pixel noise, clipped to [0, 1]:
like photographs, images differ most in their broad content, which a
classifier's logits keep after global pooling. With random weights and
pure noise images every image's logits would lie within a rounding of one
another, and the check could not tell one request's answer from another's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRID = 7

__all__ = ["float_images", "uint8_images"]


def float_images(n, h, w, c, generator, device):
    """``n`` float32 NHWC images in [0, 1]."""
    color = torch.rand((n, c, 1, 1), generator=generator, device=device)
    grid = torch.rand((n, c, GRID, GRID), generator=generator,
                      device=device) - 0.5
    low = F.interpolate(grid, size=(h, w), mode="bilinear",
                        align_corners=False)
    noise = torch.rand((n, c, h, w), generator=generator, device=device)
    x = (color + 0.5 * low + 0.2 * (noise - 0.5)).clamp_(0.0, 1.0)
    return x.permute(0, 2, 3, 1).contiguous()


def uint8_images(n, h, w, c, generator, device):
    """``n`` uint8 NHWC images: ``float_images`` at 255 levels."""
    x = float_images(n, h, w, c, generator, device)
    return torch.round(x * 255.0).to(torch.uint8)
