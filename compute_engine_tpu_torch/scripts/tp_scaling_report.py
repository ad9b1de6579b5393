"""Data-parallel scaling and the tensor-parallel modes, as a JSON report.

The port of the JAX repo's ``scripts/tp_scaling_report.py``, whose rows'
keys each row here carries:

- ``dp_scaling``: QuickNet at 32 images per data group through
  ``ShardedInterpreter`` at dp = 1, 2, 4: its latency and images/s, the
  scaling efficiency against dp = 1, and on the card the profiler's
  device-busy ms of one call, ``compile_s`` and the plan's case and
  ``host_steps``;
- ``tp_modes``: ``tp_bconv2d`` "gather", "sharded" and "pipelined" at
  QuickNet's 14x14x256 batch-128 shape over 2 and 4 model slots, each output
  held ``torch.equal`` to the single-slot ``ops.bconv2d`` and to the gather
  mode's (``bit_exact_vs_gather``), with its latency and the single slot's.

On the card every reading is compiled, as the JAX script jits both of its
measurements: ``ShardedInterpreter`` replays its graphs
(``runtime.compiled``), timed by ``benchmark.time_calls``; each
``tp_bconv2d`` mode, with every slot on one card, is captured into one
graph and timed by ``benchmark.time_forward``'s differenced replays. On the
CPU (the tests) the host clock times eager calls.

``dp_scaling``'s slots are the visible cards where they cover a mesh, else
``cuda:0`` repeated (one card then runs every slot's work); every row names
its slots. One process drives every slot.

Usage (on the card):
  python -m compute_engine_tpu_torch.scripts.tp_scaling_report [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..core import BConv2DParams, Padding, bitpack
from ..core.transforms import fuse_output_transform
from ..device import resolve_device
from ..models import convert_model, get_model, init_model
from ..ops import bconv2d
from ..parallel import make_mesh, tp_bconv2d
from ..parallel.mesh import device_slots
from ..runtime.benchmark import time_calls, time_forward
from ..runtime.distributed_serving import ShardedInterpreter

__all__ = ["dp_scaling", "tp_inputs", "tp_modes", "main"]

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "tp_scaling_h100.json")
TP_SHAPE = (128, 14, 14, 256)  # QuickNet's section-2 binary conv at b128
MODES = ("gather", "sharded", "pipelined")


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _host_ms(fn, devices, reps):
    """Host ms per call of ``fn``, each call ended by a synchronise of every
    slot, after one warm-up call (the CPU's reading)."""
    fn()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        _sync(devices)
    return (time.perf_counter() - t0) * 1e3 / reps


def dp_scaling(model="quicknet", per_group=32, dps=(1, 2, 4), iters=20,
               reps=5, device="cuda", seed=0):
    """One row per dp: ``model`` (a zoo name or a ``ModelSpec``, random
    weights from ``seed``) over a (dp, 1) mesh at ``per_group`` images per
    data group, bf16, through ``ShardedInterpreter``: ``latency_ms`` and
    ``images_per_sec`` (on the card the compiled calls by ``time_calls``
    over ``iters``, the median of ``reps``, with ``device_busy_ms`` of one
    call, ``compile_s``, the plan's ``case`` and ``host_steps``; on the
    CPU the host clock over ``reps`` calls, and those None), and
    ``scaling_efficiency``: images/s over dp times dp = 1's."""
    device = resolve_device(device)
    spec = get_model(model) if isinstance(model, str) else model
    layers = convert_model(spec, init_model(spec, seed=seed,
                                            randomize_bn=True))
    rng = np.random.default_rng(seed)
    rows = []
    for dp in dps:
        devices, where = device_slots(dp, device)
        interp = ShardedInterpreter(spec, layers,
                                    mesh=make_mesh((dp, 1), devices=devices))
        batch = per_group * dp
        x = torch.from_numpy(rng.normal(0, 1, (batch, *spec.input_size, 3))
                             .astype(np.float32)).to(devices[0])
        row = {"dp": dp, "slots": where, "batch": batch, "case": None,
               "compile_s": None, "host_steps": None,
               "device_busy_ms": None}
        if device.type == "cuda":
            buf = interp.input_buffer(x.shape, x.dtype)  # case A
            if buf is not None:
                x = buf.copy_(x)
            timed = time_calls(interp, x, iters, reps)
            key = (tuple(x.shape), x.dtype)
            ms = timed["latency_ms_p50"]
            row.update(case=interp.case, compile_s=interp.compile_s[key],
                       host_steps=interp.plan["host_steps"][key],
                       device_busy_ms=timed["device_busy_ms"])
        else:
            ms = _host_ms(lambda: interp(x), devices, reps)
        row.update(latency_ms=ms, images_per_sec=batch / ms * 1e3)
        rows.append(row)
    base = rows[0]["images_per_sec"]
    for r in rows:
        r["scaling_efficiency"] = r["images_per_sec"] / (base * r["dp"])
    return rows


def tp_inputs(shape=TP_SHAPE, seed=0):
    """Numpy inputs of one 3x3 one-padded binary conv with as many output
    as input channels: +-1 activations (N, H, W, C), a +-1 filter
    (C, 3, 3, C), and the BN multiplier (of both signs) and bias."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape

    def pm1(s):
        return np.where(rng.normal(size=s) < 0, -1.0, 1.0).astype(np.float32)

    x, filt = pm1((n, h, w, c)), pm1((c, 3, 3, c))
    post_mul = (rng.uniform(0.2, 2.0, c)
                * rng.choice([-1.0, 1.0], c)).astype(np.float32)
    post_bias = rng.uniform(-3, 3, c).astype(np.float32)
    return x, filt, post_mul, post_bias


def _on_device(t, device):
    """``t``'s per-channel arrays as tensors on ``device``, made once: a
    captured call copies nothing from the host."""
    return dataclasses.replace(t, **{
        f.name: torch.as_tensor(getattr(t, f.name)).to(device)
        for f in dataclasses.fields(t)
        if isinstance(getattr(t, f.name), np.ndarray)})


def tp_modes(shape=TP_SHAPE, tps=(2, 4), kernel="auto", iters=20, reps=5,
             device="cuda", seed=0):
    """One row per (tp, mode): ``tp_bconv2d`` with float output over a
    (1, tp) mesh whose slots all lie on ``device``, ``torch.equal`` to
    ``ops.bconv2d`` on one slot with the same ``kernel``
    (``equal_single_slot``) and to the gather mode (``bit_exact_vs_gather``),
    with ``latency_ms`` and ``single_slot_ms``: on the card each call
    captured into one graph and timed by ``time_forward`` (``compile_s``
    its first call), on the CPU the host clock over ``reps`` calls."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    x, filt, post_mul, post_bias = tp_inputs(shape, seed)
    c = shape[-1]
    xp = bitpack(torch.from_numpy(x).to(device))
    wp = bitpack(torch.from_numpy(filt).to(device))
    t = _on_device(fuse_output_transform(post_mul, post_bias, 9 * c), device)
    params = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)

    def timed(call):
        if device.type == "cuda":
            r = time_forward(call, xp, iters=iters, repeats=reps)
            return r["latency_ms_p50"], r["compile_s"]
        return _host_ms(lambda: call(xp), [device], reps), None

    def single(a):
        return bconv2d(a, wp, t, params, "float", kernel=kernel)

    want = single(xp)
    single_ms, _ = timed(single)
    rows = []
    for tp in tps:
        mesh = make_mesh((1, tp), devices=[device] * tp)
        where = f"{device} x {tp}"
        gathered = None
        for mode in MODES:
            def call(a, mode=mode):
                return tp_bconv2d(a, wp, t, params, mesh,
                                  output_kind="float", kernel=kernel,
                                  mode=mode).join(device)

            got = call(xp)
            gathered = got if gathered is None else gathered
            ms, compile_s = timed(call)
            rows.append({"mode": mode, "tp": tp, "slots": where,
                         "shape": list(shape), "kernel": kernel,
                         "latency_ms": ms, "single_slot_ms": single_ms,
                         "compile_s": compile_s,
                         "equal_single_slot": bool(torch.equal(got, want)),
                         "bit_exact_vs_gather": bool(torch.equal(got,
                                                                 gathered))})
    return rows


def main(argv=None):
    from ..runtime.microbench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    cards = torch.cuda.device_count()
    report = {
        "card": card_line(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "visible_cards": cards,
        "note": "dp_scaling: slots are the visible cards where they cover "
                "a mesh, else cuda:0 repeated, driven by one process; "
                "latency_ms is the compiled ShardedInterpreter call by "
                "differenced CUDA-event windows of 20 and 40 calls, the "
                "median of 5. tp_modes: every slot on one card, each call "
                "one captured graph, timed the same way by replays. The JAX "
                "report's dp = 8 and tp = 8 rows came from virtual CPU "
                "devices and have no counterpart here",
        "dp_scaling": dp_scaling(),
        "tp_modes": tp_modes(),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    unequal = [(r["tp"], r["mode"]) for r in report["tp_modes"]
               if not r["equal_single_slot"]]
    if unequal:
        raise SystemExit(f"tp_bconv2d modes unequal to one slot: {unequal}")


if __name__ == "__main__":
    main()
