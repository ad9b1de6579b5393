"""The port's continuous-batching engine: the cases of tests/test_serving.py,
its own semantics under fake ``infer_fn``s, and the engine over the port's
``Interpreter`` (CPU) against the JAX engine over the JAX ``Interpreter`` on
the same artifact and images. Every wait has a timeout."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.models import (convert_model as jconvert,
                                       init_model as jinit,
                                       tiny_quicknet as jtiny_quicknet)
from compute_engine_tpu.runtime import Interpreter as JInterpreter
from compute_engine_tpu.runtime.serving import ServingEngine as JServingEngine

from compute_engine_tpu_torch.models import tiny_quicknet
from compute_engine_tpu_torch.runtime import Interpreter
from compute_engine_tpu_torch.runtime.serving import (ServingEngine,
                                                      ServingStats)

import _torch_parity as parity

WAIT = 30


def _checksum_model(calls):
    def infer_fn(batch):
        calls.append(batch.shape[0])
        return batch.sum(axis=(1, 2, 3), keepdims=False)[:, None] * np.ones(
            (batch.shape[0], 4), np.float32)
    return infer_fn


def test_serving_batches_and_results(rng):
    calls = []
    images = [rng.normal(0, 1, (8, 8, 3)).astype(np.float32)
              for _ in range(50)]
    with ServingEngine(_checksum_model(calls), batch_size=16,
                       max_delay_ms=20) as eng:
        futs = [eng.submit(img) for img in images]
        outs = [f.result(timeout=WAIT) for f in futs]
    for img, out in zip(images, outs):
        np.testing.assert_allclose(out, img.sum() * np.ones(4), rtol=1e-5)
    assert all(c == 16 for c in calls)  # always the one batch shape
    assert eng.stats.requests == 50
    assert eng.stats.batches >= 4


def test_serving_propagates_errors():
    def infer_fn(batch):
        raise RuntimeError("boom")

    with ServingEngine(infer_fn, batch_size=4, max_delay_ms=5) as eng:
        fut = eng.submit(np.zeros((2, 2, 3), np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=WAIT)


def test_an_error_fails_its_batch_only_and_the_loop_carries_on():
    state = {"fail": True}

    def infer_fn(batch):
        if state.pop("fail", False):
            raise RuntimeError("once")
        return batch[:, 0, 0, :1] + 1.0

    with ServingEngine(infer_fn, batch_size=4, max_delay_ms=200) as eng:
        first = [eng.submit(np.full((2, 2, 3), i, np.float32))
                 for i in range(4)]  # one full batch: the one that fails
        for f in first:
            with pytest.raises(RuntimeError, match="once"):
                f.result(timeout=WAIT)
        later = [eng.submit(np.full((2, 2, 3), i, np.float32))
                 for i in range(4)]
        assert [float(f.result(timeout=WAIT)[0]) for f in later] == [
            1.0, 2.0, 3.0, 4.0]
    assert (eng.stats.requests, eng.stats.batches) == (4, 1)


@pytest.mark.parametrize("first,second", [
    (np.float32, np.uint8), (np.uint8, np.float32), (np.int8, np.uint8)])
def test_dtype_lock_and_type_error(first, second):
    seen = []

    def infer_fn(batch):
        seen.append(batch.dtype)
        return np.zeros((batch.shape[0], 2), np.float32)

    with ServingEngine(infer_fn, batch_size=2, max_delay_ms=1) as eng:
        eng.predict(np.zeros((2, 2, 3), first), timeout=WAIT)
        with pytest.raises(TypeError, match="does not match the engine's"):
            eng.submit(np.zeros((2, 2, 3), second))
        eng.predict(np.ones((2, 2, 3), first), timeout=WAIT)
    assert seen == [np.dtype(first)] * 2  # never promoted in the buffer


def test_input_dtype_given_and_other_floats_normalised():
    with ServingEngine(lambda b: np.zeros((len(b), 1)), batch_size=2,
                       max_delay_ms=1, input_dtype=np.uint8) as eng:
        with pytest.raises(TypeError):
            eng.submit(np.zeros((2, 2, 3), np.float32))
        eng.predict(np.zeros((2, 2, 3), np.uint8), timeout=WAIT)
    with ServingEngine(lambda b: np.zeros((len(b), 1)), batch_size=2,
                       max_delay_ms=1) as eng:
        eng.predict(np.zeros((2, 2, 3), np.float64), timeout=WAIT)
        eng.predict(np.zeros((2, 2, 3), np.float32), timeout=WAIT)  # same


def test_padding_and_stats_arithmetic():
    """Short batches are padded with zeros to ``batch_size``; the stats count
    requests, batches and padded slots."""
    batches = []

    def infer_fn(batch):
        batches.append(batch.copy())
        return batch[:, 0, 0, :1]

    with ServingEngine(infer_fn, batch_size=8, max_delay_ms=300) as eng:
        futs = [eng.submit(np.full((2, 2, 3), i + 1, np.float32))
                for i in range(11)]
        outs = [float(f.result(timeout=WAIT)[0]) for f in futs]
    assert outs == [float(i + 1) for i in range(11)]
    stats = eng.stats
    assert stats.requests == 11
    assert stats.requests + stats.padded_slots == 8 * stats.batches
    assert stats.mean_batch_fill == pytest.approx(11 / (8 * stats.batches))
    assert stats.stack_ms > 0 and stats.forward_ms > 0
    assert stats.h2d_ms == 0 and stats.d2h_ms == 0  # no card was served
    for b in batches:
        assert b.shape == (8, 2, 2, 3)
    filled = sum(int((b.reshape(8, -1) != 0).any(1).sum()) for b in batches)
    assert filled == 11  # every padded slot is zero, also in a reused buffer
    assert ServingStats().mean_batch_fill == 0.0


def test_a_full_and_a_timed_out_batch_are_each_counted():
    """A batch that reaches ``batch_size`` closes ``full``; one short of it
    closes when ``max_delay_ms`` runs out; a failed batch counts in
    neither."""
    gate = threading.Event()

    def infer_fn(batch):
        gate.wait(WAIT)
        if batch[0, 0, 0, 0] < 0:
            raise RuntimeError("refused")
        return np.zeros((batch.shape[0], 1), np.float32)

    with ServingEngine(infer_fn, batch_size=2, max_delay_ms=300,
                       input_dtype=np.float32) as eng:
        one = np.ones((2, 2, 3), np.float32)
        full = [eng.submit(one), eng.submit(one)]  # one batch of two
        gate.set()
        [f.result(timeout=WAIT) for f in full]
        eng.submit(one).result(timeout=WAIT)  # alone: 300 ms, then served
        with pytest.raises(RuntimeError, match="refused"):
            eng.submit(-one).result(timeout=WAIT)
    stats = eng.stats
    assert (stats.batches, stats.batches_full, stats.batches_timed_out) == \
        (2, 1, 1)
    assert stats.batches_full + stats.batches_timed_out == stats.batches


def test_a_request_behind_a_slow_batch_waits_at_least_its_time():
    """``queue_wait_ms`` sums each request's time from ``submit`` to the
    batcher taking it: a request submitted while a slow batch runs waits
    at least the rest of that batch."""
    started, slow_s = threading.Event(), 0.3
    ended = []

    def infer_fn(batch):
        if not started.is_set():
            started.set()
            time.sleep(slow_s)
            ended.append(time.perf_counter())
        return np.zeros((batch.shape[0], 1), np.float32)

    with ServingEngine(infer_fn, batch_size=1, max_delay_ms=1,
                       input_dtype=np.float32) as eng:
        img = np.zeros((2, 2, 3), np.float32)
        first = eng.submit(img)
        assert started.wait(WAIT)
        submitted = time.perf_counter()
        behind = eng.submit(img)
        first.result(timeout=WAIT)
        behind.result(timeout=WAIT)
    assert eng.stats.requests == 2
    assert eng.stats.queue_wait_ms >= (ended[0] - submitted) * 1e3 > 0


def test_wrong_shape_fails_its_batch_only():
    with ServingEngine(lambda b: b[:, 0, 0, :1], batch_size=1,
                       max_delay_ms=1) as eng:
        eng.predict(np.zeros((2, 2, 3), np.float32), timeout=WAIT)
        with pytest.raises(ValueError, match="request shape"):
            eng.predict(np.zeros((3, 2, 3), np.float32), timeout=WAIT)
        eng.predict(np.zeros((2, 2, 3), np.float32), timeout=WAIT)


def test_results_do_not_alias_the_reused_buffer():
    """An ``infer_fn`` that returns a view of its input: a result resolved
    from one batch is not overwritten by the next."""
    with ServingEngine(lambda b: b[:, 0, 0, :], batch_size=1,
                       max_delay_ms=1) as eng:
        a = eng.predict(np.full((2, 2, 3), 1.0, np.float32), timeout=WAIT)
        eng.predict(np.full((2, 2, 3), 2.0, np.float32), timeout=WAIT)
    np.testing.assert_array_equal(a, [1.0, 1.0, 1.0])


def test_infer_fn_may_return_a_tensor():
    def infer_fn(batch):
        return torch.from_numpy(batch).sum(dim=(1, 2)) * 2

    with ServingEngine(infer_fn, batch_size=4, max_delay_ms=1) as eng:
        out = eng.predict(np.ones((2, 2, 3), np.float32), timeout=WAIT)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, [8.0, 8.0, 8.0])


def test_close_fails_what_was_not_batched_and_refuses_new_requests():
    release = threading.Event()

    def infer_fn(batch):
        release.wait(WAIT)
        return np.zeros((batch.shape[0], 1), np.float32)

    eng = ServingEngine(infer_fn, batch_size=1, max_delay_ms=1)
    first = eng.submit(np.zeros((2, 2, 3), np.float32))
    time.sleep(0.3)  # the batcher is now inside infer_fn with the first
    waiting = eng.submit(np.zeros((2, 2, 3), np.float32))
    closer = threading.Thread(target=eng.close)
    closer.start()
    time.sleep(0.1)
    release.set()
    closer.join(WAIT)
    assert not closer.is_alive()
    assert first.result(timeout=WAIT).shape == (1,)
    with pytest.raises(RuntimeError, match="closed"):
        waiting.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros((2, 2, 3), np.float32))


def test_concurrent_submitters_lose_no_request():
    """More submitter threads than cores' worth of patience, a short switch
    interval: every request is answered with its own row, and the stats add
    up."""
    import sys

    n_threads, per_thread = 12, 25
    results = {}

    def infer_fn(batch):
        return batch[:, 0, 0, :1].copy()

    def submitter(t, eng):
        futs = [(t * 1000 + i, eng.submit(
            np.full((2, 2, 3), t * 1000 + i, np.float32)))
            for i in range(per_thread)]
        results[t] = [(tag, float(f.result(timeout=WAIT)[0]))
                      for tag, f in futs]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServingEngine(infer_fn, batch_size=16, max_delay_ms=2) as eng:
            threads = [threading.Thread(target=submitter, args=(t, eng))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == n_threads
    for rows in results.values():
        assert all(tag == val for tag, val in rows)
    stats = eng.stats
    assert stats.requests == n_threads * per_thread
    assert stats.requests + stats.padded_slots == 16 * stats.batches


@pytest.fixture(scope="module")
def tiny_model():
    jspec = jtiny_quicknet(**parity.TINY)
    return jspec, tiny_quicknet(**parity.TINY), jconvert(
        jspec, jinit(jspec, seed=3, randomize_bn=True))


def test_engine_over_the_interpreter_matches_jax(tiny_model):
    """The same artifact and images through the port's engine over the port's
    ``Interpreter`` (CPU) and through JAX's over JAX's."""
    jspec, spec, layers = tiny_model
    images = list(parity.images(4, 21))
    jinterp = JInterpreter(jspec, layers, compute_dtype=jnp.float32)
    with JServingEngine(jinterp, batch_size=8, max_delay_ms=50) as jeng:
        want = np.stack([f.result(timeout=WAIT)
                         for f in [jeng.submit(i) for i in images]])
    interp = Interpreter(spec, layers, compute_dtype=torch.float32,
                         device="cpu")
    with ServingEngine(interp, batch_size=8, max_delay_ms=50) as eng:
        got = np.stack([f.result(timeout=WAIT)
                        for f in [eng.submit(i) for i in images]])
    parity.assert_outputs_close(got, want, **parity.FLOAT32_MODEL_TOL)
    assert eng.stats.requests == 21
    assert eng.stats.requests + eng.stats.padded_slots == 8 * eng.stats.batches
    # A served row is the direct forward's row, whatever batch it rode in.
    direct = interp.predict(np.stack(images), batch_size=8)
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-6)
    # The bound __call__ is served like the interpreter itself (a tensor on
    # its device); predict, which takes arrays, gets the host buffer.
    for infer_fn in (interp.__call__, interp.predict):
        with ServingEngine(infer_fn, batch_size=8, max_delay_ms=50) as eng:
            again = np.stack([f.result(timeout=WAIT)
                              for f in [eng.submit(i) for i in images[:8]]])
        np.testing.assert_array_equal(again, direct[:8])


def test_uint8_requests_reach_the_interpreter_unwidened(tiny_model):
    """An ``input_scale`` interpreter is handed uint8 batches and widens them
    itself; the engine over it refuses a float32 request."""
    _, spec, layers = tiny_model
    interp = Interpreter(spec, layers, compute_dtype=torch.float32,
                         input_scale=1 / 127.5, input_zero_point=127,
                         device="cpu")
    seen = []

    class Spy:
        device = interp.device

        def __call__(self, x):
            seen.append((type(x), x.dtype))
            return interp(x)

    images = list(parity.images(6, 5, dtype=np.uint8))
    with ServingEngine(Spy(), batch_size=4, max_delay_ms=50) as eng:
        got = np.stack([f.result(timeout=WAIT)
                        for f in [eng.submit(i) for i in images]])
        with pytest.raises(TypeError):
            eng.submit(images[0].astype(np.float32))
    assert set(seen) == {(torch.Tensor, torch.uint8)}
    direct = Interpreter(spec, layers, compute_dtype=torch.float32,
                         device="cpu").predict(
        (np.stack(images).astype(np.float32) - 127.0) * np.float32(1 / 127.5))
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-6)


def test_interpreter_takes_a_tensor_and_keeps_integer_inputs(tiny_model):
    """``Interpreter.__call__`` on a tensor (no trip through numpy) and on
    unwidened uint8: the same output as from the array."""
    _, spec, layers = tiny_model
    interp = Interpreter(spec, layers, compute_dtype=torch.float32,
                         device="cpu")
    x = parity.images(8, 3)
    assert torch.equal(interp(torch.from_numpy(x)), interp(x))
    x8 = parity.images(8, 3, dtype=np.uint8)
    i8 = Interpreter(spec, layers, compute_dtype=torch.float32,
                     input_scale=0.02, input_zero_point=128, device="cpu")
    want = interp((x8.astype(np.float32) - 128.0) * np.float32(0.02))
    assert torch.equal(i8(torch.from_numpy(x8)), want)
    assert torch.equal(i8(x8), want)
