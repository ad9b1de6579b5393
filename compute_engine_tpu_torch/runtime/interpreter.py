"""``Interpreter`` — the user-facing inference API of the port.

Counterpart of ``compute_engine_tpu.runtime.Interpreter`` (LCE's
``tflite/python/interpreter.py``). Weights are unpacked and moved to the
device once, at construction; each call runs ``packed_apply`` eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..converter import load_artifact
from ..core.types import round_half_away, saturate_int8
from ..device import resolve_device
from ..interop import layers_from_numpy
from ..models import KERNELS, get_model, packed_apply, prepare_runtime_arrays
from ..models.zoo import ModelSpec

__all__ = ["Interpreter", "artifact_model"]


def artifact_model(name, config):
    """The model of an artifact loaded without one named: the graph program
    in its header when it carries one (a self-contained artifact needs no
    registry entry or Python model definition), else the zoo model of its
    header's name."""
    if isinstance(config, dict) and config.get("graph_program"):
        from ..converter.graph_import import spec_from_program
        return spec_from_program(
            config["graph_program"], input_size=config["input_size"],
            num_classes=config["num_classes"], name=name)
    return get_model(name)


class Interpreter:
    """Runs packed inference for a converted model artifact.

    Args:
      model: ModelSpec or zoo model name.
      layers: artifact layer dict (from ``convert_model`` or
        ``load_artifact``); if ``artifact_path`` is given it is loaded,
        and an artifact that carries its graph program needs no ``model``.
      kernel: the binary layers' lowering ("auto" | "residual" | "bgemm" |
        "mxu" | "s2d" | "reference"; see ``models.PackedBuilder``).
      compute_dtype: dtype of the activation stream between layers.
      input_scale, input_zero_point: take int8/uint8 images directly.
      output_mode: "probs", "logits" or "int8" (needs ``output_scale``).
      device: where to run; the card unless ``"cpu"`` is asked for.
    """

    def __init__(self, model=None, layers=None, artifact_path=None,
                 kernel="auto", compute_dtype=torch.bfloat16, input_scale=None,
                 input_zero_point=0, output_mode="probs", output_scale=None,
                 output_zero_point=0, device="cuda"):
        self.device = resolve_device(device)
        if artifact_path is not None:
            name, config, layers = load_artifact(artifact_path)
            if model is None:
                model = artifact_model(name, config)
        if isinstance(model, str):
            model = get_model(model)
        if not isinstance(model, ModelSpec) or layers is None:
            raise ValueError("Interpreter needs a model spec and layers "
                             "(or artifact_path)")
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                             f"{KERNELS}")
        if output_mode not in ("probs", "logits", "int8"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        if output_mode == "int8" and output_scale is None:
            raise ValueError("output_mode='int8' requires output_scale")
        self.spec = model
        self.kernel = kernel
        self.compute_dtype = compute_dtype
        self.input_scale = input_scale
        self.input_zero_point = input_zero_point
        self.output_mode = output_mode
        self.output_scale = output_scale
        self.output_zero_point = output_zero_point
        self.layers = layers_from_numpy(prepare_runtime_arrays(layers),
                                        self.device)

    # -- introspection (LCE `interpreter_base.py:30-73`) --------------------

    @property
    def input_shape(self):
        return (None, *self.spec.input_size, 3)

    @property
    def output_shape(self):
        return (None, self.spec.num_classes)

    @property
    def input_type(self):
        return np.int8 if self.input_scale is not None else np.float32

    @property
    def output_type(self):
        return np.int8 if self.output_mode == "int8" else np.float32

    @property
    def input_scales(self):
        return [self.input_scale]

    @property
    def input_zero_points(self):
        return [self.input_zero_point]

    @property
    def output_scales(self):
        return [self.output_scale]

    @property
    def output_zero_points(self):
        return [self.output_zero_point]

    def __call__(self, x) -> torch.Tensor:
        """Forward one batch; returns a tensor on the interpreter's device.

        ``x`` is array-like or a tensor (one already on the device is used
        where it lies). It crosses to the device in its own dtype: int8 or
        uint8 images for an ``input_scale`` interpreter are widened to
        float32 on the device, a quarter of the bytes over the bus."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.to(self.device, non_blocking=True)
        if self.input_scale is not None:
            x = ((x.to(torch.float32) - float(self.input_zero_point))
                 * float(self.input_scale))
        elif x.dtype != torch.float32:
            x = x.to(torch.float32)
        out = packed_apply(self.spec, self.layers, x, kernel=self.kernel,
                           compute_dtype=self.compute_dtype,
                           return_logits=self.output_mode == "logits",
                           device=self.device)
        if self.output_mode == "int8":
            q = out / float(self.output_scale) + float(self.output_zero_point)
            out = saturate_int8(round_half_away(q).to(torch.int32))
        return out

    def _numpy(self, x):
        return self(x).cpu().numpy()

    def predict(self, x, batch_size: int | None = None):
        """Predict class probabilities (or logits / int8) as numpy.

        Accepts one image (H, W, 3) or a batch (N, H, W, 3). ``batch_size``
        splits a large input into chunks of that size; the last chunk is
        padded with zeros to the same shape and cut back.
        """
        x = np.asarray(x, np.float32)
        single = x.ndim == 3
        if single:
            x = x[None]
        if batch_size is None or x.shape[0] <= batch_size:
            out = self._numpy(x)
        else:
            chunks = []
            for i in range(0, x.shape[0], batch_size):
                chunk = x[i:i + batch_size]
                if chunk.shape[0] < batch_size:
                    pad = np.zeros((batch_size - chunk.shape[0],
                                    *x.shape[1:]), np.float32)
                    chunks.append(self._numpy(
                        np.concatenate([chunk, pad]))[:chunk.shape[0]])
                else:
                    chunks.append(self._numpy(chunk))
            out = np.concatenate(chunks)
        return out[0] if single else out
