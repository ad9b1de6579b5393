"""The system under test, made from a configuration and a seed: the raw
weights (the reference's weight maker, on the device), the port's
``convert_model`` of them and its ``Interpreter`` over the result.

This is the only module of the harness that imports the program
(``compute_engine_tpu_torch``); the references and the counts never do.
"""

from __future__ import annotations

import hashlib
import time

import torch

from . import spec

__all__ = ["derive", "generator", "set_float32_flags", "build",
           "launch_counts"]


def derive(seed, tag):
    """A 63-bit seed for the draw named ``tag`` of run ``seed``: the
    weights, the inputs and the schedule draw from separate streams."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def set_float32_flags(config):
    """The configuration's float32 settings, set for the process; returns
    them as set."""
    flags = config["float32_flags"]
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul_allow_tf32"])
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def build(config, seed, device, input_scale=None, model=None):
    """``(params, interpreter, steps)``: the float parameter tree drawn
    from ``seed`` (CPU tensors, what the reference reads too), the port's
    ``Interpreter`` over ``convert_model`` of it, and the seconds of each
    step. ``model`` overrides the zoo model the
    configuration names (small models in the tests)."""
    from compute_engine_tpu_torch.models import convert_model, get_model
    from compute_engine_tpu_torch.runtime.interpreter import Interpreter

    steps = {}
    t = time.perf_counter()
    ref = spec.module("reference", config["reference"])
    params = ref.make_params(config, derive(seed, "weights"), device)
    steps["weights"] = time.perf_counter() - t
    model = model or get_model(config["model"])
    layers = convert_model(model, params)
    steps["convert_model"] = time.perf_counter() - steps["weights"] - t
    interp = Interpreter(
        model=model, layers=layers, kernel=config["kernel"],
        compute_dtype=getattr(torch, config["compute_dtype"]),
        input_scale=input_scale, output_mode=config["output_mode"],
        device=device)
    steps["interpreter"] = time.perf_counter() - sum(steps.values()) - t
    return params, interp, steps


def launch_counts():
    """The port's own launch counts of its hand-written kernels
    (``kernels/counts.py``): replays add their graph's launches."""
    from compute_engine_tpu_torch.kernels.bgemm import bgemm
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    return {"residual_block": binary_residual_block.launches,
            "bgemm": bgemm.launches,
            "bgemm_splitk": bgemm.splitk_launches}
