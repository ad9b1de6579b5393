"""Profiling labels: the counterpart of ruy's ScopeLabel instrumentation.

LCE wraps every kernel in ``ruy::profiler::ScopeLabel`` and its benchmark
tool prints a time tree by label. Here ``annotate`` puts a label around a
function that shows in both of the card's tools: an NVTX range (Nsight
Systems) and a ``torch.profiler.record_function`` span (the Chrome trace and
``key_averages()``); ``trace`` captures a ``torch.profiler`` trace of the
enclosed block into a directory.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["annotate", "trace"]


def annotate(label: str):
    """Decorator: run a function inside an NVTX range and a profiler span
    named ``label``. Without a card the NVTX range is left out."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            nvtx = torch.cuda.is_available()
            if nvtx:
                torch.cuda.nvtx.range_push(label)
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host, and the card when there is one) and
    write a Chrome trace, ``trace.json``, into ``log_dir``. Yields the
    ``torch.profiler.profile`` object, for ``key_averages()`` afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
