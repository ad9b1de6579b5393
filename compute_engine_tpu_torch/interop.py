"""Weights carried across: numpy parameter trees and artifacts -> the port.

A parameter tree or an artifact written by the JAX package is plain numpy
(``.npz`` on disk), so nothing here imports JAX.

* ``params_from_numpy``: a parameter tree (nested dicts of arrays) -> the
  port's tree of float32 CPU tensors.
* ``layers_from_numpy``: artifact layers (numpy, ``uint32`` packed words) ->
  runtime layers (C-contiguous tensors on a device, packed words viewed as
  ``int32``, since torch has no right shift for ``uint32`` on the CPU).
  Scalars and strings pass through; tensors are moved to the device. In an
  int8 artifact ``kernel_int8`` stays int8 and ``w_scale`` float32, the
  ``in_scale``/``out_scale`` stay Python floats, and an ``"add"`` entry,
  which holds no array, passes through whole.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "layers_from_numpy"]


def params_from_numpy(params):
    """Nested dict of arrays -> nested dict of float32 CPU tensors."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v) for k, v in params.items()}
    return torch.from_numpy(np.array(params, dtype=np.float32, copy=True))


def _tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device).contiguous()
    if isinstance(v, np.ndarray) and v.ndim > 0:
        v = np.array(v, order="C")  # a writable, contiguous copy
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        return torch.from_numpy(v).to(device)
    return v


def layers_from_numpy(layers, device="cpu"):
    """Artifact layer dict -> runtime layer dict on ``device``."""
    return {name: {k: _tensor(v, device) for k, v in entry.items()}
            for name, entry in layers.items()}
