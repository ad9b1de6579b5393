"""The compiled forward (``runtime.compiled``) on the CPU, with stand-ins for
the card's graph and stream objects put in by ``monkeypatch``.

The stand-in graph records every operation the capture runs (a
``TorchDispatchMode``) and a replay runs them again on the same tensors,
writing each result into the tensor the capture produced: what a CUDA graph
does with its kernels and their addresses. It refuses a host read of a
tensor's value inside a capture, as a capture on the card does. With it the
CPU tests reach the cache of graphs, the static input, the output clone,
the launch ledger, the refusals (debug checks, a failed capture) and
``benchmark_model``'s differencing; the card runs the real objects in
``chip_smoke.py``'s compiled phase.

Stated tolerances: compiled against eager outputs ``torch.equal``; the
differenced latencies against the JAX formula within 1e-12 relative; the
section rows against the JAX script's rounded ones within 5e-4 ms.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet

from compute_engine_tpu_torch.kernels import counts, debug, debug_checks
from compute_engine_tpu_torch.kernels.bgemm import bgemm
from compute_engine_tpu_torch.kernels.residual import binary_residual_block
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             tiny_quicknet)
from compute_engine_tpu_torch.runtime import Interpreter
from compute_engine_tpu_torch.runtime import benchmark as bm
from compute_engine_tpu_torch.runtime import compiled
from compute_engine_tpu_torch.runtime.compiled import CompiledForward
from compute_engine_tpu_torch.runtime.serving import ServingEngine
from compute_engine_tpu_torch.scripts import section_profile as sp

import _torch_card_standins as standins
import _torch_parity as parity
from _torch_card_standins import FakeEvent, FakeGraph

REPO = pathlib.Path(__file__).parents[1]
CPU = torch.device("cpu")
WAIT = 30


@pytest.fixture
def fake_card(monkeypatch):
    """The card's graph, stream and event objects replaced by stand-ins;
    returns the record of captures."""
    return standins.install(monkeypatch)


def _restore_counts(monkeypatch):
    for fn, attr in ((binary_residual_block, "launches"),
                     (bgemm, "launches"), (bgemm, "splitk_launches")):
        monkeypatch.setattr(fn, attr, 0)


def _counted():
    return (binary_residual_block.launches, bgemm.launches,
            bgemm.splitk_launches)


# -- CompiledForward -----------------------------------------------------------


@pytest.mark.parametrize("keys, captures", [
    ([((2, 3), torch.float32)] * 3, 1),
    ([((2, 3), torch.float32), ((4, 3), torch.float32),
      ((2, 3), torch.float32)], 2),
    ([((2, 3), torch.float32), ((2, 3), torch.float64),
      ((2, 3), torch.int8), ((2, 3), torch.float64)], 3),
])
def test_one_capture_per_shape_and_dtype(fake_card, keys, captures):
    calls = []

    def fn(x):
        calls.append(x.shape)
        return x.to(torch.float32) * 2 + 1

    cf = CompiledForward(fn, CPU)
    rng = np.random.default_rng(0)
    for shape, dtype in keys:
        x = torch.from_numpy(rng.integers(-9, 9, shape)).to(dtype)
        assert torch.equal(cf(x), x.to(torch.float32) * 2 + 1)
    assert len(fake_card["captures"]) == captures == len(cf.compile_s)
    assert set(cf.compile_s) == {(tuple(s), d) for s, d in keys}
    assert all(t >= 0 for t in cf.compile_s.values())
    # Python runs fn only to warm up and to capture: replays run the graph.
    assert len(calls) == captures * (compiled.WARMUP + 1)
    assert sum(g.replays for g in FakeGraph.made) == len(keys)
    assert all(mode == "thread_local" for _, _, mode in fake_card["captures"])


def test_output_is_not_aliased_across_calls(fake_card):
    cf = CompiledForward(lambda x: x * 3, CPU)
    a, b = torch.arange(6.0), torch.arange(6.0) + 10
    out_a = cf(a)
    out_b = cf(b)
    assert torch.equal(out_a, a * 3) and torch.equal(out_b, b * 3)
    assert out_a.data_ptr() != out_b.data_ptr()
    out_b.zero_()
    assert torch.equal(cf(b), b * 3)


def test_static_input_is_not_copied_again(fake_card):
    cf = CompiledForward(lambda x: x + 1, CPU)
    buf = cf.input_buffer((4,), torch.float32)
    assert buf is cf.input_buffer([4], torch.float32)
    buf.copy_(torch.arange(4.0))
    assert torch.equal(cf(buf), torch.arange(4.0) + 1)
    buf.fill_(7)
    assert torch.equal(cf(buf), torch.full((4,), 8.0))


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_launch_counts_grow_by_the_captured_counts(fake_card, monkeypatch,
                                                   calls):
    """A stand-in forward that launches two blocks, one GEMM and one split-K
    GEMM: the warm-up and the capture count nothing, each call adds the
    captured launches once."""
    _restore_counts(monkeypatch)

    def fn(x):
        counts.count(binary_residual_block)
        counts.count(binary_residual_block)
        counts.count(bgemm)
        counts.count(bgemm, "splitk_launches")
        return x + 1

    cf = CompiledForward(fn, CPU)
    for _ in range(calls):
        cf(torch.zeros(3))
    assert _counted() == (2 * calls, calls, calls)
    counts.count(bgemm)  # eager, outside any recording
    assert _counted() == (2 * calls, calls + 1, calls)


def test_recording_is_per_thread(monkeypatch):
    _restore_counts(monkeypatch)
    with counts.recording() as ledger:
        counts.count(bgemm)
        t = threading.Thread(target=counts.count, args=(bgemm,))
        t.start()
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert ledger == {(bgemm, "launches"): 1}
    assert bgemm.launches == 1  # the other thread's launch
    counts.add(ledger, 3)
    assert bgemm.launches == 4


def test_debug_checks_refuse_a_compiled_forward(fake_card, monkeypatch):
    cf = CompiledForward(lambda x: x + 1, CPU)
    cf(torch.zeros(2))
    with debug_checks():
        with pytest.raises(RuntimeError, match="debug_checks"):
            cf(torch.zeros(2))
    # A launch that a capture would take refuses too, before any library.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="cannot\\s+be captured"):
        debug.begin(None, 0)


def test_a_failed_capture_raises_and_never_runs_eagerly(fake_card):
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    cf = CompiledForward(fn, CPU)
    fake_card["fail"] = "operation not permitted when stream is capturing"
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="not permitted"):
            cf(torch.zeros(2))
        assert len(calls) == attempt * (compiled.WARMUP + 1)
    assert cf.compile_s == {}
    fake_card["fail"] = None
    assert torch.equal(cf(torch.zeros(2)), torch.ones(2))


# -- Interpreter through the compiled forward ---------------------------------


def _interpreter(spec, layers, compiled_cls=CompiledForward, **kw):
    """A CPU interpreter with its forward compiled through the stand-ins, as
    a card's interpreter compiles it, and an eager one beside it."""
    interp = Interpreter(spec, layers, device="cpu", **kw)
    eager = Interpreter(spec, layers, device="cpu", **kw)
    interp._compiled = compiled_cls(interp._forward, CPU)
    return interp, eager


MODES = {
    "probs_bf16": (dict(), np.float32),
    "logits_f32": (dict(output_mode="logits", compute_dtype=torch.float32),
                   np.float32),
    "int8_images": (dict(input_scale=1 / 64.0, input_zero_point=3),
                    np.int8),
    "uint8_images_int8_out": (dict(input_scale=1 / 127.5,
                                   input_zero_point=128, output_mode="int8",
                                   output_scale=1 / 256.0,
                                   output_zero_point=-128), np.uint8),
}


@pytest.fixture(scope="module")
def tiny():
    spec = tiny_quicknet(**parity.TINY)
    return spec, convert_model(spec, init_model(spec, seed=0,
                                                randomize_bn=True))


@pytest.mark.parametrize("mode", MODES)
def test_compiled_interpreter_equals_eager(fake_card, tiny, mode):
    """The widening of integer images and the int8 requantisation are
    inside the compiled forward; every call equals the eager forward and
    reads no value on the host."""
    spec, layers = tiny
    kw, dtype = MODES[mode]
    interp, eager = _interpreter(spec, layers, **kw)
    for seed in (1, 2):
        x = parity.images(seed, 3, dtype=dtype)
        got = interp(x)
        assert torch.equal(got, eager(x))
        assert got.dtype == (torch.int8 if "int8_out" in mode
                             else torch.float32)
    assert len(fake_card["captures"]) == 1
    x = parity.images(3, 5, dtype=dtype)
    assert np.array_equal(interp.predict(x, batch_size=3),
                          eager.predict(x, batch_size=3))
    # predict pads its last chunk to the compiled shape (and, as JAX's,
    # takes its images as float32).
    assert {shape for shape, _ in interp.compile_s} == {(3, 32, 32, 3)}


def test_compiled_interpreter_reads_weights_in_place(fake_card, tiny):
    """Weights are read where they lie, as jit arguments are: negating one
    block's filter in place (its packed words, which the kernel reads, and
    its +-1 form, which the plain version reads) changes the next replay as
    it changes the eager forward."""
    spec, layers = tiny
    interp, eager = _interpreter(spec, layers, output_mode="logits")
    x = parity.images(4, 2)
    before = interp(x)
    name = next(k for k, v in interp.layers.items() if "filter_pm1" in v)
    for it in (interp, eager):
        entry = it.layers[name]
        entry["packed_filter"].copy_(~entry["packed_filter"])
        entry["filter_pm1"].copy_(-entry["filter_pm1"])
    after = interp(x)
    assert torch.equal(after, eager(x))
    assert not torch.equal(after, before)
    assert len(fake_card["captures"]) == 1


def test_compiled_interpreter_refuses_debug_checks(fake_card, tiny):
    spec, layers = tiny
    interp, eager = _interpreter(spec, layers)
    x = parity.images(5, 2)
    with debug_checks():
        with pytest.raises(RuntimeError, match="debug_checks"):
            interp(x)
        eager(x)  # the eager forward runs the checks on the CPU


class _OnTheCard:
    """An interpreter as the engine sees one on a card: its ``device`` says
    CUDA, and its calls and static inputs are the compiled CPU
    interpreter's."""

    def __init__(self, interp):
        self.interp, self.device = interp, torch.device("cuda")

    def input_buffer(self, shape, dtype):
        return self.interp.input_buffer(shape, dtype)

    def __call__(self, x):
        return self.interp(x)


def test_serving_stages_into_the_static_input(fake_card, tiny, monkeypatch):
    """Over an interpreter on a card, each batch is copied from the pinned
    host buffer straight into the compiled forward's static input, the graph
    is captured on the batcher thread and every served row equals the
    direct forward."""
    spec, layers = tiny
    seen = []

    class Spy(CompiledForward):
        def __call__(self, x):
            seen.append(x)
            return super().__call__(x)

    interp, eager = _interpreter(spec, layers, compiled_cls=Spy)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    images = parity.images(6, 10)
    with ServingEngine(_OnTheCard(interp), batch_size=4,
                       max_delay_ms=20) as eng:
        rows = [eng.submit(img).result(timeout=WAIT) for img in images[:4]]
        rows += [f.result(timeout=WAIT)
                 for f in [eng.submit(img) for img in images[4:]]]
    buf = interp.input_buffer((4, 32, 32, 3), torch.float32)
    assert len(seen) == eng.stats.batches >= 4
    assert all(b is buf for b in seen)
    assert [c[0] for c in fake_card["captures"]] == [eng._thread.name]
    padded = np.zeros((12, 32, 32, 3), np.float32)
    padded[:10] = images
    direct = np.concatenate([eager(padded[i:i + 4]).numpy()
                             for i in (0, 4, 8)])
    for i, row in enumerate(rows):
        assert np.array_equal(row, direct[i])


# -- benchmark_model ------------------------------------------------------------


def _jax_latency(t_k, t_2k, iters, batch):
    """JAX's ``benchmark_model`` arithmetic (``runtime/benchmark.py``) on
    seconds, unrounded."""
    times = np.asarray([max((b - a) / iters, 1e-9)
                        for a, b in zip(t_k, t_2k)])
    p50 = float(np.percentile(times, 50))
    return {"latency_ms_p50": p50 * 1e3,
            "latency_ms_mean": float(times.mean()) * 1e3,
            "latency_ms_min": float(times.min()) * 1e3,
            "images_per_sec": batch / p50}


@pytest.mark.parametrize("t_k, t_2k, iters, batch", [
    ([10.0, 11.0, 9.5, 10.2, 10.1], [19.0, 21.5, 18.9, 20.0, 20.4], 10, 128),
    ([3.0, 3.2, 2.9], [5.5, 6.1, 5.8], 4, 1),
    ([1.0, 1.0], [0.9, 1.1], 2, 8),  # a negative difference is floored
])
def test_differencing_is_jaxs(t_k, t_2k, iters, batch):
    got = bm.differenced_latency(t_k, t_2k, iters, batch)
    want = _jax_latency(np.asarray(t_k) / 1e3, np.asarray(t_2k) / 1e3,
                        iters, batch)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)


def test_time_forward_differences_the_event_times(fake_card, monkeypatch):
    """The event times of each pair (T(k), then T(2k)) go through the
    differencing; compile_s is the first call; replays count launches."""
    _restore_counts(monkeypatch)

    def forward(x):
        counts.count(binary_residual_block)
        return x * 2

    FakeEvent.queue = [4.0, 8.4, 4.2, 8.0, 4.1, 8.3]
    x = torch.ones(8, 2)
    got = bm.time_forward(forward, x, iters=2, warmup=3, repeats=3)
    want = bm.differenced_latency([4.0, 4.2, 4.1], [8.4, 8.0, 8.3], 2, 8)
    assert got == {"compile_s": got["compile_s"], **want}
    assert got["compile_s"] >= 0
    assert [c[1] for c in fake_card["captures"]] == ["pool", "pool"]
    # Launches of every replay: k and 2k forwards, once to warm and three
    # times timed; the eager warm-up counts nothing.
    assert binary_residual_block.launches == (2 + 4) * 4


def _load_jax_script(name):
    """One of the JAX repo's scripts/ as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", str(REPO / "scripts" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_result_keys_are_jaxs(fake_card, monkeypatch):
    """A tiny spec: JAX's ``benchmark_model`` on the CPU and the port's over
    the stand-ins give the same keys, but the port's documented extras and
    the peak HBM figure (measured on the card, estimated by JAX where its
    backend has no allocator statistics)."""
    from compute_engine_tpu.runtime.benchmark import \
        benchmark_model as jbenchmark

    jspec = jtiny_quicknet(**parity.TINY)
    want = jbenchmark(jspec, batch=2, iters=1, warmup=1, repeats=1)
    spec = tiny_quicknet(**parity.TINY)
    prepare = bm.prepare_forward
    # "cuda" names the stand-in card, "cpu" is where the tensors lie.
    monkeypatch.setattr(bm, "resolve_device", torch.device)
    monkeypatch.setattr(bm, "prepare_forward",
                        lambda *a: prepare(*a[:7], "cpu", *a[8:]))
    FakeEvent.queue = [1.0, 2.5] * 2
    got = bm.benchmark_model(spec, batch=2, iters=1, repeats=2)
    extras = {"compute_dtype", "domain", "int8_pipeline"}
    assert set(got) == ((set(want) - {"peak_hbm_est_mb", "peak_hbm_mb"})
                        | {"peak_hbm_mb"} | extras)
    assert got["latency_ms_p50"] == 1.5 and got["compile_s"] >= 0
    assert got["images_per_sec"] == 2 / 1.5e-3
    assert (got["model"], got["batch"], got["peak_hbm_mb"]) == (
        spec.name, 2, 3.0)


# -- the section profile -------------------------------------------------------


def test_section_profile_differences_like_jaxs_script(monkeypatch):
    """Both scripts over stubbed ``benchmark_model`` readings of the same
    prefixes: the port's rows equal the JAX script's (which rounds to 3
    places), and both pass JAX's chain length and repeats."""
    cumulative = [0.6, 0.9, 1.15, 1.5, 1.95, 2.2, 2.45, 2.5]
    names = [spec.name for _, spec in sp.prefixes()]
    latency = dict(zip(names, cumulative))
    calls = {"jax": [], "port": []}

    def stub(side):
        def benchmark_model(model, batch, iters, warmup, repeats, **kw):
            calls[side].append((model.name, batch, iters, repeats))
            ms = latency[model.name]
            return {"latency_ms_p50": ms, "images_per_sec": batch / ms * 1e3,
                    "device_busy_ms": 0.9 * ms}
        return benchmark_model

    import compute_engine_tpu.runtime.benchmark as jbm

    jsp = _load_jax_script("section_profile")
    written = io.StringIO()
    monkeypatch.setattr(jbm, "benchmark_model", stub("jax"))
    monkeypatch.setattr(jsp, "open", lambda *a, **k: contextlib.nullcontext(
        written), raising=False)
    monkeypatch.setattr(sys, "argv", ["section_profile.py"])
    jsp.main()
    want = json.loads(written.getvalue())
    monkeypatch.setattr(sp, "benchmark_model", stub("port"))
    monkeypatch.setattr(sp, "resolve_device", lambda d: torch.device("cuda"))
    got = sp.profile(want["batch"])
    assert calls["port"] == calls["jax"]
    assert [r["name"] for r in got["sections"]] == [
        r["name"] for r in want["sections"]] == list(sp.ROWS)
    for g, w in zip(got["sections"], want["sections"]):
        assert g["ms"] == pytest.approx(w["ms"], abs=5e-4)
        assert g["device_busy_ms"] == pytest.approx(0.9 * g["ms"], rel=1e-9)
    assert got["iters"] == want["iters"]
    assert got["whole_model"]["ms"] == pytest.approx(
        want["whole_model"]["ms"], abs=5e-4)
