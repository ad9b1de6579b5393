"""The harness's tests: CPU tests, and tests marked ``card`` that need a
CUDA card and skip without one (decided in a fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def tiny(name):
    """``(config, model)``: the configuration ``name`` at a size the CPU
    runs in seconds, and the port's model of the same shape, from
    ``tiny/<model>.py`` of the configuration's ``model``."""
    from portbench import spec

    cfg = spec.config(name)
    return spec.module("tiny", cfg["model"]).tiny(cfg)


def tiny_workload(cell):
    """The cell's workload file with its sizes cut for the CPU."""
    from portbench import spec

    wl = spec.workload(cell)
    p = wl["params"]
    for key, value in dict(batch=min(p.get("batch", 8), 8), pool=8,
                           batch_size=8, rate=200, sample=32,
                           drain_s=5).items():
        if key in p:
            p[key] = value
    return wl
