"""Benchmark of packed inference on the card (LCE ``lce_benchmark_model``).

Measures what the JAX package's ``benchmark_model`` measures: the
steady-state latency of the compiled forward on the device. Two CUDA graphs
are captured, one of ``iters`` forwards and one of ``2 * iters``, sharing one
memory pool (``runtime.compiled``); each replay is timed by CUDA events, and
``(T(2k) - T(k)) / k`` cancels what a replay costs apart from its forwards.
The latency is the median over ``repeats``. ``compile_s`` is the first call:
the eager warm-up forwards (the kernels' build or load among them), the
capture of the ``iters`` graph and its first replay. JAX's loop perturbs its
input from one forward to the next so that XLA hoists nothing out of the
loop; a replayed graph hoists nothing, so the port's forwards all read the
same input. There is no CPU mode: without a card it raises.

Usage:
  python -m compute_engine_tpu_torch.runtime.benchmark --model quicknet \\
      [--batch 8] [--iters 20] [--warmup 3] [--repeats 5] [--kernel auto] \\
      [--artifact q.npz] [--input-size 224] [--f32] [--domain packed] \\
      [--int8] [--json]

It prints JAX's key/value table, or with ``--json`` one JSON line. The
defaults are JAX's: ``benchmark_model()`` times batch 8 after one warm-up
forward, the command line batch 8 after three.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..converter import load_artifact
from ..device import resolve_device
from ..interop import layers_from_numpy
from ..models import (KERNELS, calibrate_model, convert_model, get_model,
                      init_model, packed_apply, prepare_runtime_arrays)
from .compiled import capture_plan, warm_up_plan
from .interpreter import artifact_model

__all__ = ["benchmark_model", "prepare_forward", "time_forward",
           "time_calls", "differenced_latency", "device_busy_ms",
           "memory_metrics", "activation_peak_bytes"]

_BUSY_TRACES = 2  # profiler traces device_busy_ms takes at most


def memory_metrics(layers, x):
    """``weights_mb``: bytes of every array the runtime holds on the device
    (packed filters, the +-1 filters unpacked at load, transforms, float
    kernels), and ``input_mb``: bytes of the input batch; MiB rounded to 2
    places, as the JAX package's ``_memory_metrics`` reports them. ``layers``
    are runtime layers (``layers_from_numpy(prepare_runtime_arrays(...))``),
    ``x`` the input tensor."""
    weight_bytes = sum(v.numel() * v.element_size()
                       for entry in layers.values() for v in entry.values()
                       if isinstance(v, torch.Tensor) and v.dim() > 0)
    return {"weights_mb": round(weight_bytes / 2 ** 20, 2),
            "input_mb": round(x.numel() * x.element_size() / 2 ** 20, 2)}


def activation_peak_bytes(forward):
    """Bytes of the largest tensor any operation creates in one call of
    ``forward``: every op's output, intermediates such as an im2col
    included, as JAX's benchmark takes the largest value of its traced
    program. Kernels launched through ctypes write into tensors that torch
    allocated, which count too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    best = [0]

    class Largest(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    best[0] = max(best[0], t.numel() * t.element_size())
            return out

    with Largest():
        forward()
    return best[0]


def prepare_forward(model=None, batch=8, seed=0, kernel="auto",
                    artifact_path=None, compute_dtype=torch.bfloat16,
                    input_size=None, device="cuda", domain="float",
                    int8_pipeline=False):
    """The forward that ``benchmark_model`` times, built on ``device``:
    returns ``(spec, layers, x, forward)``, the runtime layers, the input
    batch (normal draws from ``seed``) and a callable that runs
    ``packed_apply`` on them (``forward(inp)`` on another input of the same
    shape). The arguments are ``benchmark_model``'s: an artifact is timed
    as it was converted, and ``int8_pipeline`` is ignored there, as JAX
    ignores it. On a card the allocator's peak is reset once the weights
    are made, before they are copied there."""
    device = resolve_device(device)
    if artifact_path is not None:
        name, config, layers_np = load_artifact(artifact_path)
        if model is None:
            spec = artifact_model(name, config)
        else:
            spec = get_model(model) if isinstance(model, str) else model
    else:
        model = "quicknet" if model is None else model
        spec = get_model(model) if isinstance(model, str) else model
        params = init_model(spec, seed=seed, randomize_bn=True)
        ranges = {}
        if int8_pipeline:
            crng = np.random.default_rng(seed + 1)
            in_r, out_r = calibrate_model(
                spec, params,
                [crng.normal(0, 1, (8, *(input_size or spec.input_size), 3))
                 .astype(np.float32) for _ in range(2)],
                with_outputs=True, device=device)
            ranges = {"int8_ranges": in_r, "int8_out_ranges": out_r}
        layers_np = convert_model(spec, params, **ranges)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    layers = layers_from_numpy(prepare_runtime_arrays(layers_np, spec),
                              device)
    size = tuple(input_size or spec.input_size)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (batch, *size, 3))
                         .astype(np.float32)).to(device)

    def forward(inp=x):
        return packed_apply(spec, layers, inp, kernel=kernel,
                            compute_dtype=compute_dtype, device=device,
                            domain=domain)

    return spec, layers, x, forward


def device_busy_ms(forward, n=3):
    """Device time per call of ``forward`` on the card: the sum of the
    kernels' and copies' device time in a ``torch.profiler`` trace of ``n``
    calls (after one untraced call), over ``n``. A trace that holds no
    device record is taken again, up to ``_BUSY_TRACES`` in all (one such
    trace was seen on the H100, in a process started beside another that
    had profiled for minutes); ``None`` when none held any. Unlike a host
    clock around eager calls it does not move with the rate at which the
    host enqueues launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    for _ in range(_BUSY_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / n
    return None


def differenced_latency(t_k_ms, t_2k_ms, iters, batch):
    """JAX's differencing arithmetic on the event times (ms) of ``repeats``
    pairs of replays, one of ``iters`` forwards and one of ``2 * iters``:
    each pair gives ``(T(2k) - T(k)) / k`` ms per forward (at least 1e-6
    ms, as JAX floors it at 1e-9 s); returns ``latency_ms_p50`` (the
    median), ``latency_ms_mean``, ``latency_ms_min`` and ``images_per_sec``
    at the median."""
    times = np.maximum((np.asarray(t_2k_ms, np.float64)
                        - np.asarray(t_k_ms, np.float64)) / iters, 1e-6)
    p50 = float(np.percentile(times, 50))
    return {"latency_ms_p50": p50, "latency_ms_mean": float(times.mean()),
            "latency_ms_min": float(times.min()),
            "images_per_sec": batch / (p50 / 1e3)}


def _iterated(forward, n):
    def run(inp):
        for _ in range(n):
            out = forward(inp)
        return out

    return run


def _replayer(fn, x, pool):
    """A callable that replays ``fn(x)`` captured into a graph of ``pool``
    on ``x``'s device and adds the graph's launches to the kernels'
    counts."""
    steps, _ = capture_plan(fn, x, [x.device], {x.device: pool})

    def replay():
        for step in steps:
            step.run()

    return replay


def time_forward(forward, x, iters=20, warmup=3, repeats=5,
                 device_busy=False):
    """The compiled timing of ``forward(x)`` on the card, as
    ``benchmark_model`` describes it: ``warmup`` eager forwards (at least
    one), graphs of ``iters`` and ``2 * iters`` forwards in one pool,
    ``repeats`` timed pairs of replays. Returns ``compile_s`` and
    ``differenced_latency``'s keys; with ``device_busy``,
    ``device_busy_ms``, the profiler's device time of one replay of a
    one-forward graph. The graphs share their pool because nothing reads
    their outputs. Every replay adds its kernels' launches to their counts
    (``kernels.counts``)."""
    device = x.device
    pool = torch.cuda.graph_pool_handle()
    t0 = time.perf_counter()
    warm_up_plan(forward, x, [device], max(warmup, 1))
    run_k = _replayer(_iterated(forward, iters), x, pool)
    run_k()
    torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    run_2k = _replayer(_iterated(forward, 2 * iters), x, pool)
    run_2k()
    t_k, t_2k = [], []
    for _ in range(repeats):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        run_k()
        marks[1].record()
        run_2k()
        marks[2].record()
        marks[2].synchronize()
        t_k.append(marks[0].elapsed_time(marks[1]))
        t_2k.append(marks[1].elapsed_time(marks[2]))
    out = {"compile_s": compile_s,
           **differenced_latency(t_k, t_2k, iters, x.shape[0])}
    if device_busy:
        out["device_busy_ms"] = device_busy_ms(_replayer(forward, x, pool))
    return out


def time_calls(call, x, iters=20, repeats=5):
    """The timing of ``call(x)`` where each call replays captured graphs (a
    ``ShardedInterpreter`` on the card, whose forward may span cards and so
    is no one graph to capture again): ``time_forward``'s differencing over
    windows of ``iters`` and ``2 * iters`` calls, timed by CUDA events on
    the current stream of the calling thread's card (where the calls leave
    their output), the median of ``repeats``. The first call, which
    compiles, is not timed. Returns ``differenced_latency``'s keys and
    ``device_busy_ms``, the profiler's device time of one call."""
    call(x)
    torch.cuda.synchronize()
    t_k, t_2k = [], []
    for _ in range(repeats):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        for _ in range(iters):
            call(x)
        marks[1].record()
        for _ in range(2 * iters):
            call(x)
        marks[2].record()
        marks[2].synchronize()
        t_k.append(marks[0].elapsed_time(marks[1]))
        t_2k.append(marks[1].elapsed_time(marks[2]))
    out = differenced_latency(t_k, t_2k, iters, x.shape[0])
    out["device_busy_ms"] = device_busy_ms(lambda: call(x))
    return out


def benchmark_model(model=None, batch=8, iters=20, warmup=1, repeats=5,
                    seed=0, kernel="auto", artifact_path=None,
                    compute_dtype=torch.bfloat16, input_size=None,
                    device="cuda", domain="float", int8_pipeline=False,
                    device_busy=False, binary_dtype=None):
    """Latency, images/s and memory of the compiled packed forward at
    ``batch`` on the card, timed as the module docstring says
    (``time_forward``).

    Without ``artifact_path`` the weights are random from ``seed``
    (``init_model(randomize_bn=True)``) for ``model`` (QuickNet when none is
    named). With it, the artifact is loaded with ``load_artifact`` and its
    model is ``model`` if given, else the graph program in its header or the
    zoo model of its name, as ``Interpreter`` does. ``input_size`` overrides
    the model's (H, W). ``kernel`` chooses the binary layers' lowering (see
    ``models.PackedBuilder``). ``domain="packed"`` chains binary layers
    through bitpacked activations.

    ``int8_pipeline`` (no artifact) times the true-int8 execution mode: the
    model is calibrated on two random batches of 8 (from ``seed + 1``) and
    converted with input and output ranges. With an artifact it is ignored,
    as JAX ignores it. ``binary_dtype`` is accepted and ignored: JAX's TPU
    operand type has no meaning on the card (see ``models.PackedBuilder``).
    The defaults are JAX's (``batch=8``, ``warmup=1``).

    The result has the keys of JAX's result (``compile_s``,
    ``latency_ms_p50``, ``latency_ms_mean``, ``latency_ms_min``,
    ``images_per_sec``, ``weights_mb``, ``input_mb``, ``act_peak_mb``,
    ``peak_hbm_mb``) and the port's: ``compute_dtype``, ``domain`` (JAX
    names it only when it is "packed"), ``int8_pipeline``, and with
    ``device_busy`` the profiler's device time of one replay,
    ``device_busy_ms``. Memory: ``weights_mb`` and ``input_mb``
    (``memory_metrics``), ``act_peak_mb`` (``activation_peak_bytes`` of one
    eager forward) and ``peak_hbm_mb``, the allocator's peak over the whole
    run, the graphs' memory pool included, in MiB.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("benchmark_model times the card; it has no CPU mode")
    int8_pipeline = int8_pipeline and artifact_path is None
    spec, layers, x, forward = prepare_forward(
        model, batch, seed, kernel, artifact_path, compute_dtype, input_size,
        device, domain, int8_pipeline)
    timed = time_forward(forward, x, iters, warmup, repeats, device_busy)
    act_peak = activation_peak_bytes(forward)
    return {
        "model": spec.name,
        "batch": batch,
        "kernel": kernel,
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "domain": domain,
        "int8_pipeline": int8_pipeline,
        "device": torch.cuda.get_device_name(device),
        **timed,
        **memory_metrics(layers, x),
        "act_peak_mb": round(act_peak / 2 ** 20, 2),
        "peak_hbm_mb": round(torch.cuda.max_memory_allocated(device)
                             / 2 ** 20, 1),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default=None,
                   help="zoo model (default quicknet, or the artifact's)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kernel", default="auto", choices=KERNELS)
    p.add_argument("--artifact", default=None,
                   help="time a converted artifact (.npz)")
    p.add_argument("--input-size", type=int, default=None,
                   help="square input size in place of the model's")
    p.add_argument("--f32", action="store_true",
                   help="float32 activation stream instead of bfloat16")
    p.add_argument("--domain", default="float", choices=["float", "packed"],
                   help="packed: chain binary layers through bitpacked "
                        "activations")
    p.add_argument("--int8", action="store_true",
                   help="true-int8 pipeline (calibrated; int8 stream, int8 "
                        "residual adds)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line in place of the key/value table")
    args = p.parse_args(argv)
    size = (args.input_size, args.input_size) if args.input_size else None
    result = benchmark_model(
        model=args.model, batch=args.batch, iters=args.iters,
        warmup=args.warmup, repeats=args.repeats, seed=args.seed,
        kernel=args.kernel, artifact_path=args.artifact, input_size=size,
        compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
        domain=args.domain, int8_pipeline=args.int8)
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k:18s} {v}")


if __name__ == "__main__":
    main()
