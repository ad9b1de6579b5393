"""Data-parallel scaling and the tensor-parallel modes, as a JSON report.

The port of the JAX repo's ``scripts/tp_scaling_report.py``:

- ``dp_scaling``: QuickNet at 32 images per data group through
  ``ShardedInterpreter`` (``parallel.partition.sharded_apply``) at dp = 1,
  2, 4: images/s of a forward by the host clock (ended by a synchronise),
  the profiler's device-busy ms per forward, and the scaling efficiency
  against dp = 1;
- ``tp_modes``: ``tp_bconv2d`` "gather", "sharded" and "pipelined" at
  QuickNet's 14x14x256 batch-128 shape over 2 and 4 model slots, each output
  held ``torch.equal`` to the single-slot ``ops.bconv2d``, with its ms.

Slots are the visible cards where they cover a mesh, else ``cuda:0``
repeated (one card then runs every slot's work, one after another); every
row names its slots. One process drives every slot.

Usage (on the card):
  python -m compute_engine_tpu_torch.scripts.tp_scaling_report [--out FILE]
"""

from __future__ import annotations

import argparse
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
from ..runtime.benchmark import device_busy_ms
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
    slot, after one warm-up call."""
    fn()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        _sync(devices)
    return (time.perf_counter() - t0) * 1e3 / reps


def dp_scaling(model="quicknet", per_group=32, dps=(1, 2, 4), reps=5,
               device="cuda", seed=0):
    """One row per dp: ``model`` (a zoo name or a ``ModelSpec``, random
    weights from ``seed``) over a (dp, 1) mesh at ``per_group`` images per
    data group, bf16. ``images_per_sec`` from the host clock,
    ``device_busy_ms`` from the profiler (on a card), and
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
        ms = _host_ms(lambda: interp(x), devices, reps)
        busy = (device_busy_ms(lambda: interp(x))
                if devices[0].type == "cuda" else None)
        rows.append({"dp": dp, "slots": where, "batch": batch,
                     "ms": ms, "images_per_sec": batch / ms * 1e3,
                     "device_busy_ms": busy})
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


def tp_modes(shape=TP_SHAPE, tps=(2, 4), kernel="auto", reps=5,
             device="cuda", seed=0):
    """One row per (tp, mode): ``tp_bconv2d`` with float output over a
    (1, tp) mesh, ``torch.equal`` (``equal_single_slot``) to ``ops.bconv2d``
    on one slot with the same ``kernel``, and its host ms per call."""
    device = resolve_device(device)
    x, filt, post_mul, post_bias = tp_inputs(shape, seed)
    c = shape[-1]
    xp = bitpack(torch.from_numpy(x).to(device))
    wp = bitpack(torch.from_numpy(filt).to(device))
    t = fuse_output_transform(post_mul, post_bias, 9 * c)
    params = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
    want = bconv2d(xp, wp, t, params, "float", kernel=kernel)
    single_ms = _host_ms(lambda: bconv2d(xp, wp, t, params, "float",
                                         kernel=kernel), [device], reps)
    rows = []
    for tp in tps:
        devices, where = device_slots(tp, device)
        mesh = make_mesh((1, tp), devices=devices)
        for mode in MODES:
            def call(mode=mode):
                return tp_bconv2d(xp, wp, t, params, mesh,
                                  output_kind="float", kernel=kernel,
                                  mode=mode).join(device)

            got = call()
            rows.append({"mode": mode, "tp": tp, "slots": where,
                         "shape": list(shape), "kernel": kernel,
                         "ms": _host_ms(call, devices, reps),
                         "single_slot_ms": single_ms,
                         "equal_single_slot": bool(torch.equal(got, want))})
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
        "note": "slots are the visible cards where they cover a mesh, else "
                "cuda:0 repeated, driven by one process; ms is the host "
                "clock per call ended by a synchronise; the JAX report's "
                "dp = 8 and tp = 8 rows came from virtual CPU devices and "
                "have no counterpart here",
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
