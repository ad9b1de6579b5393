"""Benchmark of packed inference on the card (LCE ``lce_benchmark_model``).

Times whole forwards with CUDA events: warm-up forwards first (the first one
builds the kernels), then ``repeats`` windows of ``iters`` forwards each; the
latency of a window is its event time over ``iters``, and the result is the
median window. There is no CPU fallback: without a card it raises.

Usage:
  python -m compute_engine_tpu_torch.runtime.benchmark --model quicknet \
      --batch 128 [--iters 20] [--repeats 5] [--f32] [--domain packed] \
      [--int8]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..interop import layers_from_numpy
from ..models import (calibrate_model, convert_model, get_model, init_model,
                      packed_apply, prepare_runtime_arrays)


def benchmark_model(model="quicknet", batch=128, iters=20, warmup=3,
                    repeats=5, seed=0, compute_dtype=torch.bfloat16,
                    device="cuda", domain="float", int8_pipeline=False):
    """Latency and images/s of ``packed_apply`` at ``batch`` on the card.

    Weights are random from ``seed`` (``init_model(randomize_bn=True)``).
    ``domain="packed"`` chains binary layers through bitpacked activations
    (BinaryAlexNet's conv2-5 and fc1 run bitpacked in and out).

    ``int8_pipeline`` times the true-int8 execution mode: the model is
    calibrated on two random batches of 8 (from ``seed + 1``) and converted
    with input and output ranges, so non-binary layers run in int8, binary
    convs write int8 through the binary GEMM's epilogue, and the calibrated
    residual adds run as int8 ADDs."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("benchmark_model times the card; it has no CPU mode")
    spec = get_model(model) if isinstance(model, str) else model
    params = init_model(spec, seed=seed, randomize_bn=True)
    ranges = {}
    if int8_pipeline:
        crng = np.random.default_rng(seed + 1)
        in_r, out_r = calibrate_model(
            spec, params,
            [crng.normal(0, 1, (8, *spec.input_size, 3)).astype(np.float32)
             for _ in range(2)], with_outputs=True, device=device)
        ranges = {"int8_ranges": in_r, "int8_out_ranges": out_r}
    layers = layers_from_numpy(prepare_runtime_arrays(convert_model(
        spec, params, **ranges)), device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (batch, *spec.input_size, 3))
                         .astype(np.float32)).to(device)

    def forward():
        return packed_apply(spec, layers, x, compute_dtype=compute_dtype,
                            device=device, domain=domain)

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize(device)
    first_call_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        forward()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            forward()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times = np.asarray(times)
    p50 = float(np.median(times))
    return {
        "model": spec.name,
        "batch": batch,
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "domain": domain,
        "int8_pipeline": int8_pipeline,
        "device": torch.cuda.get_device_name(device),
        "first_call_s": first_call_s,
        "latency_ms_p50": p50,
        "latency_ms_min": float(times.min()),
        "latency_ms_max": float(times.max()),
        "images_per_sec": batch / (p50 / 1e3),
        "peak_mem_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="quicknet")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f32", action="store_true",
                   help="float32 activation stream instead of bfloat16")
    p.add_argument("--domain", default="float", choices=["float", "packed"],
                   help="packed: chain binary layers through bitpacked "
                        "activations")
    p.add_argument("--int8", action="store_true",
                   help="true-int8 pipeline (calibrated; int8 stream, int8 "
                        "residual adds)")
    args = p.parse_args(argv)
    print(json.dumps(benchmark_model(
        model=args.model, batch=args.batch, iters=args.iters,
        warmup=args.warmup, repeats=args.repeats, seed=args.seed,
        compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
        domain=args.domain, int8_pipeline=args.int8)))


if __name__ == "__main__":
    main()
