#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``compute_engine_tpu_torch``) on one
NVIDIA GPU (written for an H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build every CUDA source of the port with nvcc, in parallel.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes QuickNet gives it at batch 128 and at a ragged channel count:
   ``torch.equal`` with an identity transform, with a random transform, and
   without the residual add.
3. Drive the main path: QuickNet (224x224x3, sections 64/128/256/512, 4+4+4+4
   blocks, 1000 classes) at batch 128 with random weights from seed 0,
   ``init_model -> convert_model -> Interpreter.predict``; the launch counts
   are set to 0 just before and read just after. Check the output (finite,
   probabilities, shape) and its top-1 against the same forward through the
   plain versions on the card.
4. Time ``benchmark_model`` (images/s), print a torch.profiler breakdown of
   the forward's device time by kernel, and time each kernel at each shape
   beside its bound, its plain version and a library yardstick (cuDNN's
   bf16 conv of pre-signed +-1 inputs, timed only).

The last lines are the ``kernels`` JSON object, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA device, or outside a checkout of the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor-core ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

QUICKNET_BLOCKS = [(128, 56, 56, 64), (128, 28, 28, 128), (128, 14, 14, 256),
                   (128, 7, 7, 512)]
RAGGED = (4, 9, 9, 48)
BLOCKS_PER_SHAPE = 4  # QuickNet: 4 blocks in each of the four sections
TOLERANCE = "torch.equal (bit for bit)"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_forward(forward, n=3, top=12):
    """Device time per forward by kernel, from a torch.profiler trace of
    ``n`` forwards (informational: it checks nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("[profile] the profiler saw no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    print(f"[profile] per forward under the profiler: device busy {busy:.3f} "
          f"ms of {wall_ms:.3f} ms wall, idle share {1 - busy / wall_ms:.3f}")
    for ms, count, name in rows[:top]:
        print(f"[profile] {ms:8.4f} ms {count:5.1f}x {name[:100]}")


def block_case(rng, shape, device, dtype, identity):
    """Inputs of one residual block: x (with exact +0.0 and -0.0 entries),
    the packed +-1 filter and a fused transform."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.core import bitpack_np, fuse_output_transform

    n, h, w, c = shape
    x = rng.normal(0, 1, shape).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    x.reshape(-1)[1::89] = -0.0
    filt = rng.choice([-1.0, 1.0], size=(c, 3, 3, c)).astype(np.float32)
    if identity:
        post_mul, post_bias = np.ones(c), np.zeros(c)
    else:
        post_mul = (rng.uniform(0.1, 2.0, c)
                    * rng.choice([-1.0, 1.0], c)).astype(np.float32)
        post_bias = rng.uniform(-5, 5, c).astype(np.float32)
    tr = fuse_output_transform(post_mul, post_bias, 9 * c)
    tr = type(tr)(clamp_min=tr.clamp_min, clamp_max=tr.clamp_max,
                  multiplier=torch.from_numpy(tr.multiplier).to(device),
                  bias=torch.from_numpy(tr.bias).to(device))
    pf = torch.from_numpy(bitpack_np(filt).view(np.int32)).to(device)
    xt = torch.from_numpy(x).to(device).to(dtype).contiguous()
    return xt, pf, tr


def block_work(shape):
    """Bytes and operations of one block: bf16 x read and out written once,
    filter words and transform read once; 2 * 9 * C int8-equivalent
    operations per output."""
    n, h, w, c = shape
    nbytes = 2 * n * h * w * c * 2 + c * 9 * (-(-c // 32)) * 4 + 2 * c * 4
    return nbytes, 2 * n * h * w * c * 9 * c


def bound(nbytes, ops):
    """Least time (ms) for the work and what sets it, against the H100's
    memory rate and int8 tensor-core rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import compute_engine_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    import numpy as np

    from compute_engine_tpu_torch.core import BConv2DParams, Padding, bitunpack
    from compute_engine_tpu_torch.kernels import _build
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model, packed_apply)
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. Build.
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")

    # 2. Kernel against its plain version.
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = [(s, torch.bfloat16) for s in QUICKNET_BLOCKS + [RAGGED]]
    cases.append((RAGGED, torch.float32))
    for shape, dtype in cases:
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=1)
        for label, identity, residual in (("identity", True, True),
                                          ("random", False, True),
                                          ("no-residual", False, False)):
            x, pf, tr = block_case(rng, shape, dev, dtype, identity)
            got = binary_residual_block(x, pf, tr, p, has_residual=residual)
            torch.cuda.synchronize()
            want = binary_residual_block_plain(x, pf, tr, p,
                                               has_residual=residual)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"residual_block {shape} {dtype} {label}: kernel != plain "
                  f"(max |diff| {err})")
            print(f"[compare] residual_block {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]} {label}: equal ({TOLERANCE})", flush=True)

    # 3. The main path: QuickNet at batch 128 through the Interpreter.
    spec = get_model("quicknet")
    t0 = time.perf_counter()
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    interp = Interpreter(spec, layers)
    x = rng.normal(0, 1, (128, *spec.input_size, 3)).astype(np.float32)
    print(f"[quicknet] init + convert + load {time.perf_counter() - t0:.2f} s",
          flush=True)
    binary_residual_block.launches = 0
    probs = interp.predict(x)
    torch.cuda.synchronize()
    launches = binary_residual_block.launches
    check(launches == 16, f"16 residual block launches per forward, got "
          f"{launches}")
    check(probs.shape == (128, 1000), f"output shape {probs.shape}")
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(np.allclose(probs.sum(-1), 1.0, atol=1e-3), "rows do not sum to 1")
    plain = packed_apply(spec, interp.layers, x,
                         residual_block=binary_residual_block_plain)
    plain = plain.cpu().numpy()
    agree = float((probs.argmax(-1) == plain.argmax(-1)).mean())
    diff = float(np.abs(probs - plain).max())
    print(f"[quicknet] batch 128: {launches} kernel launches, top-1 agreement "
          f"with the plain path {agree:.4f}, max |dprob| {diff:.3g}",
          flush=True)
    check(agree == 1.0, f"top-1 agreement with the plain path {agree}")

    # 4. Timing.
    bench = benchmark_model("quicknet", batch=128, iters=10, warmup=3,
                            repeats=5, device=dev)
    print(f"[bench] quicknet b128 bf16: {bench['images_per_sec']:.1f} images/s,"
          f" p50 {bench['latency_ms_p50']:.3f} ms/forward [{card}] "
          f"{json.dumps(bench)}", flush=True)
    x_dev = torch.from_numpy(x).to(dev)
    profile_forward(lambda: packed_apply(spec, interp.layers, x_dev))
    shapes = []
    for shape in QUICKNET_BLOCKS:
        n, h, w, c = shape
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        x, pf, tr = block_case(rng, shape, dev, torch.bfloat16, False)
        # The plain version gets the filter unpacked once, as on the main
        # path (prepare_runtime_arrays).
        upf = bitunpack(pf, c, dtype=torch.int8).permute(1, 2, 3, 0)
        ms = time_ms(lambda: binary_residual_block(x, pf, tr, p), reps=50)
        plain_ms = time_ms(
            lambda: binary_residual_block_plain(x, pf, tr, p,
                                                unpacked_filter=upf),
            reps=5, warm=1)
        xs = torch.where(x < 0, -1.0, 1.0).to(torch.bfloat16)
        xs = xs.permute(0, 3, 1, 2)  # channels_last NCHW view
        ws = torch.from_numpy(rng.choice([-1.0, 1.0], size=(c, c, 3, 3))).to(
            dev, torch.bfloat16)
        lib_ms = time_ms(
            lambda: torch.nn.functional.conv2d(xs, ws, padding=1), reps=50)
        bound_ms, bound_by = bound(*block_work(shape))
        shapes.append({"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms})
        print(f"[time] residual_block {n}x{h}x{w}x{c} bf16: kernel {ms:.4f} ms,"
              f" plain {plain_ms:.4f} ms, cuDNN bf16 conv {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)

    def per_forward(key):
        return sum(BLOCKS_PER_SHAPE * s[key] for s in shapes)

    # The line's numbers are per QuickNet forward: 16 launches, 4 per shape.
    work = [block_work(s) for s in QUICKNET_BLOCKS]
    bound_fw, bound_by = bound(
        BLOCKS_PER_SHAPE * sum(b for b, _ in work),
        BLOCKS_PER_SHAPE * sum(o for _, o in work))
    kernels = [{
        "name": "residual_block",
        "route": "cuda",
        "source": "compute_engine_tpu_torch/csrc/residual_block.cu",
        "replaces": "compute_engine_tpu/kernels/residual.py:86",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": bound_fw,
        "bound_by": bound_by,
        "library_ms": per_forward("library_ms"),
        "per": "one QuickNet batch-128 forward (16 launches)",
        "shapes": shapes,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
