"""The baseline configurations on the card: latency, throughput, serving.

The port of the JAX repo's ``scripts/baseline_matrix.py``. One record per
(model, batch) configuration, each through ``runtime.benchmark``: the p50
latency of the compiled forward and images/s (CUDA-graph replays of
``iters`` and ``2 * iters`` forwards, differenced, as JAX's timer), the
first call's seconds (``compile_s``: eager warm-up, the kernels' build or
load among it, capture and the first replay), the memory figures, and the
profiler's device-busy ms of one replay beside every latency. Batch-1 rows
of the reference's published models also carry the reference's own
one-thread latency on a Mac Mini M1 CPU (its published figure, labelled
with that hardware) and the ratio to it.

``bench_serving``: BinaryDenseNet-45 through ``ServingEngine`` over an
``Interpreter`` that takes int8 images (scale 1/64, zero point 0), closed
loop: each client submits its own image and waits for its result; every
result is held ``torch.equal`` to its row of a direct forward.

Usage (on the card; ``--configs`` merges a subset into the file):
  python -m compute_engine_tpu_torch.scripts.baseline_matrix \\
      [--configs quicknet_small:1,quicknet:128,quicknet:128:int8,serving] \\
      [--skip-serving] [--serving-seconds 30] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import convert_model, get_model, init_model
from ..runtime.benchmark import benchmark_model
from ..runtime.interpreter import Interpreter
from ..runtime.serving import ServingEngine

__all__ = ["DEFAULT_CONFIGS", "INT8_CONFIGS", "REF_BATCH1_MS", "bench_config",
           "bench_serving", "parse_configs", "bad_rows", "main"]

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "baseline_matrix_h100.json")

# (model, batch) latency and throughput configurations; serving runs apart.
DEFAULT_CONFIGS = [
    ("quicknet_small", 1), ("quicknet", 1), ("quicknet_large", 1),
    ("birealnet18", 1),
    ("quicknet_small", 128), ("quicknet", 128), ("quicknet_large", 128),
    ("birealnet18", 128),
]
# The true-int8 pipeline's rows (int8 stream, int8 residual adds).
INT8_CONFIGS = [("quicknet", 128, True), ("quicknet", 1, True)]

# The reference's best published one-thread latency of each model on a Mac
# Mini M1 (CPU), in ms: the vs-reference column. Bi-RealNet has no M1
# figure; its Pixel-1 figure (41.6 ms) is scaled by QuickNet's Pixel-1 to
# M1 ratio (5.8 / 25.5), as the JAX script does, and the record says so.
REF_BATCH1_MS = {"quicknet_small": 4.0, "quicknet": 5.8,
                 "quicknet_large": 9.9, "birealnet18": 41.6 * (5.8 / 25.5)}
REF_HARDWARE = "Mac Mini M1, one thread (the reference's published figure)"


def bench_config(model, batch, iters=None, repeats=5, int8=False,
                 device="cuda"):
    """One configuration's record: ``model`` (a zoo name or a ``ModelSpec``)
    at ``batch``, ``kernel="auto"``, the bf16 stream or the true-int8
    pipeline, timed by ``benchmark_model`` (the median of ``repeats``
    differenced pairs of CUDA-graph replays of ``iters`` and ``2 * iters``
    forwards, and the profiler's device-busy ms of one replay)."""
    # JAX's chain lengths: a batch-1 forward is short, so a longer chain.
    iters = iters or (200 if batch == 1 else 20)
    r = benchmark_model(model=model, batch=batch, iters=iters, warmup=2,
                        repeats=repeats, kernel="auto", int8_pipeline=int8,
                        device=device, device_busy=True)
    name = model if isinstance(model, str) else model.name
    rec = {
        "model": name, "batch": batch, "kernel": "auto",
        **({"pipeline": "int8"} if int8 else {}),
        "latency_ms_p50": r["latency_ms_p50"],
        "per_image_ms_p50": r["latency_ms_p50"] / batch,
        "images_per_sec": r["images_per_sec"],
        "device_busy_ms": r["device_busy_ms"],
        "iters": iters,
        "compile_s": r["compile_s"],
        "weights_mb": r["weights_mb"],
    }
    for k in ("peak_hbm_mb", "act_peak_mb"):
        rec[k] = r[k]
    ref = REF_BATCH1_MS.get(name)
    if batch == 1 and ref is not None:
        rec["ref_m1_1thread_ms"] = round(ref, 2)
        rec["speedup_vs_ref_m1"] = ref / r["latency_ms_p50"]
        rec["ref_note"] = REF_HARDWARE
        if name == "birealnet18":
            rec["ref_note"] += ("; no M1 figure published: Pixel-1 41.6 ms "
                                "scaled by QuickNet's Pixel-1 to M1 ratio")
    return rec


def bench_serving(model="binary_densenet45", batch_size=128, n_clients=256,
                  duration_s=30.0, max_delay_ms=10.0, device="cuda", seed=0):
    """``model`` (a zoo name or a ``ModelSpec``) through the continuous-
    batching ``ServingEngine``: ``n_clients`` closed-loop clients (more than
    ``batch_size``, so that batches can fill), each sending its own int8
    image and waiting for the result, for ``duration_s``. Returns
    requests/s, request latency p50/p99, ``mean_batch_fill`` and batches,
    and ``results_equal_direct``: every served result ``torch.equal`` to its
    row of a direct forward of the clients' images in batches of
    ``batch_size``."""
    device = resolve_device(device)
    spec = get_model(model) if isinstance(model, str) else model
    layers = convert_model(spec, init_model(spec, seed=seed,
                                            randomize_bn=True))
    # int8 images: a quarter of float32's bytes from host to device.
    interp = Interpreter(spec, layers, input_scale=1 / 64.0,
                         input_zero_point=0, device=device)
    rng = np.random.default_rng(seed)
    images = np.clip(rng.normal(0, 64, (n_clients, *spec.input_size, 3)),
                     -128, 127).astype(np.int8)
    # The direct forward, in full batches (zero rows pad the last one), as
    # the engine pads its batches.
    padded = -(-n_clients // batch_size) * batch_size
    stack = np.zeros((padded, *images.shape[1:]), np.int8)
    stack[:n_clients] = images
    with torch.no_grad():
        direct = torch.cat([interp(stack[i:i + batch_size]).cpu()
                            for i in range(0, padded, batch_size)])
    lock = threading.Lock()
    latencies, wrong = [], [0]
    done_at = time.monotonic() + duration_s

    with ServingEngine(interp, batch_size=batch_size,
                       max_delay_ms=max_delay_ms) as eng:
        def client(k):
            while time.monotonic() < done_at:
                t0 = time.monotonic()
                got = eng.predict(images[k], timeout=60)
                dt = time.monotonic() - t0
                same = torch.equal(torch.as_tensor(got), direct[k])
                with lock:
                    latencies.append(dt)
                    wrong[0] += not same

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t_start
        stats = eng.stats
    lat = np.asarray(latencies)
    return {
        "model": spec.name, "mode": "serving_engine",
        "input": "int8 images, input_scale 1/64, zero point 0",
        "batch_size": batch_size, "n_clients": n_clients,
        "max_delay_ms": max_delay_ms, "duration_s": elapsed,
        "requests": len(latencies),
        "requests_per_sec": len(latencies) / elapsed,
        "request_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "request_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "mean_batch_fill": stats.mean_batch_fill,
        "batches": stats.batches,
        "results_equal_direct": wrong[0] == 0,
        "results_unequal": wrong[0],
    }


def parse_configs(text):
    """``model:batch[:int8]`` items and ``serving``, comma-separated ->
    (configs, serving)."""
    configs, serving = [], False
    for item in text.split(","):
        if item == "serving":
            serving = True
        elif item.endswith(":int8"):
            m, b, _ = item.split(":")
            configs.append((m, int(b), True))
        else:
            m, b = item.rsplit(":", 1)
            configs.append((m, int(b), False))
    return configs, serving


def bad_rows(data):
    """The names of ``data``'s rows (``main``'s file) with a number that is
    not finite and positive among their times and rates, or a served result
    unequal to the direct forward."""
    keys = ("latency_ms_p50", "images_per_sec", "device_busy_ms",
            "requests_per_sec", "request_p50_ms", "request_p99_ms",
            "mean_batch_fill")
    bad = []
    for name, rec in data.items():
        if name.startswith("_"):
            continue
        vals = [rec[k] for k in keys if k in rec]
        if (not vals or not all(v is not None and np.isfinite(v) and v > 0
                                for v in vals)
                or rec.get("results_equal_direct") is False):
            bad.append(name)
    return bad


def main(argv=None):
    from ..runtime.microbench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=None,
                   help="comma list of model:batch[:int8] or 'serving'; a "
                        "subset is merged into the existing file")
    p.add_argument("--skip-serving", action="store_true")
    p.add_argument("--serving-seconds", type=float, default=30.0)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if args.configs:
        configs, serving = parse_configs(args.configs)
    else:
        configs = [(m, b, False) for m, b in DEFAULT_CONFIGS] + INT8_CONFIGS
        serving = not args.skip_serving
    try:
        with open(args.out) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    card = card_line()
    data["_meta"] = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "timer": "benchmark_model: CUDA-graph replays of iters and 2 iters "
                 "forwards timed by CUDA events, (T(2k) - T(k)) / k, median "
                 "of 5; compile_s: warm-up, capture and first replay; "
                 "device_busy_ms: torch.profiler device time of one replay",
        "weights": "random, init_model(seed=0, randomize_bn=True)",
        "ref_m1_1thread_ms": REF_HARDWARE,
    }

    def write():
        with open(args.out, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)

    for model, batch, int8 in configs:
        rec = bench_config(model, batch, int8=int8)
        data[f"{model}@{batch}" + ("@int8" if int8 else "")] = rec
        print(json.dumps(rec), f"[{card}]", flush=True)
        write()
    if serving:
        rec = bench_serving(duration_s=args.serving_seconds)
        data[f"{rec['model']}@serving"] = rec
        print(json.dumps(rec), f"[{card}]", flush=True)
        write()
    print("wrote", args.out, flush=True)
    bad = bad_rows(data)
    if bad:
        raise SystemExit(f"rows not finite and positive: {bad}")


if __name__ == "__main__":
    main()
