"""Profiling spans: the counterpart of ruy's ScopeLabel instrumentation.

LCE wraps every kernel in ``ruy::profiler::ScopeLabel`` and its benchmark
tool prints a time tree by label. Here ``span`` is the one mechanism: a
context manager that, while a profiler runs, is a
``torch.profiler.record_function`` range, a user annotation on kineto's
clock, the clock of the CUPTI device events, so that every idle gap of the
card can be put down to the span open over it. With no profiler running it
reads one flag and returns a shared no-op context: it makes no
``record_function`` object and no NVTX call; an ``Interpreter`` call
reads the flag once for all of its spans. ``annotate`` is ``span`` as a
decorator; ``trace`` profiles the enclosed block, every thread of the
process, into a Chrome trace. For Nsight Systems, run under
``torch.autograd.profiler.emit_nvtx()``: every span becomes an NVTX range
there.

"A profiler runs" is ``torch.autograd.profiler._is_profiler_enabled``,
which ``torch.profiler.profile``, ``emit_nvtx`` and ``emit_itt`` set for
the whole process while they run. (``torch.autograd._profiler_enabled()``
is per thread, and reads false on every thread of a profile that takes all
threads, as ``trace`` does.)

What is recorded when. Every call of an ``Interpreter`` records its own
spans (``interpreter/*`` and, on the card, the compiled forward's
``compiled/*``) at each call. A span inside a forward that a CUDA graph
holds (``runtime.compiled``: an ``Interpreter`` on the card,
``benchmark_model``) is recorded once, when the graph is captured, and not
at its replays, which run no Python; to read time by span or by kernel
name inside a forward, profile ``packed_apply``, which runs eagerly.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["annotate", "span", "trace"]

_OFF = contextlib.nullcontext()


def _on(name):
    return torch.profiler.record_function(name)


def _off(name):
    return _OFF


def span(name: str):
    """A context manager: a profiler span named ``name`` while a profiler
    runs, else a no-op after one check."""
    return _spans()(name)


def _spans():
    """The port's own span maker for one pass down a path of several
    spans (an ``Interpreter`` call): ``span`` without its check while a
    profiler runs, else a maker of no-op contexts, so the path checks
    once."""
    return _on if _autograd_profiler._is_profiler_enabled else _off


def annotate(label: str):
    """Decorator: run a function inside ``span(label)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host, and the card when there is one),
    every thread of the process (a ``ServingEngine``'s batcher among them),
    and write a Chrome trace, ``trace.json``, into ``log_dir``. Yields the
    ``torch.profiler.profile`` object, for ``key_averages()`` afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
