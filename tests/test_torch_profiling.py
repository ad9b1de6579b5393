"""The port's profiling labels on the CPU: ``annotate`` is transparent to the
function it wraps and its label shows in a trace; ``trace`` writes a file."""

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
    batch. The profiler follows the thread that started it, so the batch is
    served here on this thread, through the batcher's own method."""
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


def test_exports_match_the_jax_package():
    import compute_engine_tpu.utils as jutils

    assert profiling.__all__ == ["annotate", "trace"]
    assert {"annotate", "trace"} <= set(dir(jutils))
