"""The port's profiling spans on the CPU: ``annotate`` is transparent to the
function it wraps and its label shows in a trace; ``span`` records only
while a profiler runs; ``trace`` writes a file and sees every thread."""

import json
import os

import pytest
import torch

from compute_engine_tpu_torch.utils import annotate, trace
from compute_engine_tpu_torch.utils import profiling


def test_annotate_is_transparent():
    @annotate("test/label")
    def f(a, b=2, *, c=3):
        """doc"""
        return a + b + c

    assert f(1) == 6 and f(1, 5, c=0) == 6
    assert f.__name__ == "f" and f.__doc__ == "doc"
    x = torch.arange(4.0)
    assert torch.equal(annotate("test/tensor")(lambda t: t * 2)(x), x * 2)


def test_annotate_passes_exceptions_through():
    @annotate("test/raises")
    def f():
        raise KeyError("inside")

    with pytest.raises(KeyError, match="inside"):
        f()


def test_trace_writes_a_chrome_trace_with_the_label(tmp_path):
    log_dir = str(tmp_path / "nested" / "trace")

    @annotate("test/matmul")
    def work():
        return torch.ones(8, 8) @ torch.ones(8, 8)

    with trace(log_dir) as prof:
        work()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test/matmul" for e in events)
    assert any(e.key == "test/matmul" for e in prof.key_averages())


def test_the_serving_loop_is_annotated(tmp_path):
    """``serving/stack+h2d`` and ``serving/forward`` are the spans of a served
    batch, served here on this thread through the batcher's own method."""
    from concurrent.futures import Future

    import numpy as np

    from compute_engine_tpu_torch.runtime.serving import ServingEngine

    eng = ServingEngine(lambda b: np.ones((len(b), 1)), batch_size=2,
                        max_delay_ms=1, input_dtype=np.float32)
    eng.close()
    fut = Future()
    with trace(str(tmp_path)) as prof:
        eng._serve([(np.zeros((2, 2, 3), np.float32), fut)])
    assert fut.result(timeout=30).tolist() == [1.0]
    keys = {e.key for e in prof.key_averages()}
    assert {"serving/stack+h2d", "serving/forward"} <= keys


def test_the_batcher_thread_is_traced(tmp_path):
    """``trace`` profiles every thread: a request served through the
    engine's own batcher thread shows its two spans."""
    import numpy as np

    from compute_engine_tpu_torch.runtime.serving import ServingEngine

    with ServingEngine(lambda b: np.ones((len(b), 1)), batch_size=2,
                       max_delay_ms=1, input_dtype=np.float32) as eng:
        with trace(str(tmp_path)) as prof:
            row = eng.submit(np.zeros((2, 2, 3), np.float32)).result(
                timeout=30)
    assert row.tolist() == [1.0]
    keys = {e.key for e in prof.key_averages()}
    assert {"serving/stack+h2d", "serving/forward"} <= keys


def test_span_records_only_while_a_profiler_runs(monkeypatch):
    """Off, ``span`` and the port's one-check span maker make no
    ``record_function``; on, a span shows in the profile."""
    def refuse(*a, **k):
        raise AssertionError("a span recorded with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        with profiling.span("test/off"):
            pass
        with profiling._spans()("test/off"):
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("test/on"):
            torch.ones(2) + 1
        with profiling._spans()("test/on_too"):
            torch.ones(2) + 1
    keys = {e.key for e in prof.key_averages()}
    assert {"test/on", "test/on_too"} <= keys
    # user annotations, as the benchmark's trace reads host spans
    marked = {e.name(): e.is_user_annotation()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("test/")}
    assert marked == {"test/on": True, "test/on_too": True}


def test_exports_match_the_jax_package():
    """JAX's two names are among the port's, which adds ``span``."""
    import compute_engine_tpu.utils as jutils

    assert {"annotate", "trace"} <= set(profiling.__all__)
    assert profiling.__all__ == ["annotate", "span", "trace"]
    assert {"annotate", "trace"} <= set(dir(jutils))
