"""QuickNet per section on the card, each section beside its floors.

The port of the JAX repo's ``scripts/section_profile.py``. It times model
prefixes (stem_conv; +stem_depthwise; +stem_pointwise; +section_0; ...;
+head) and subtracts consecutive prefixes, so that each section is measured
inside the whole forward. A prefix's time is its ``benchmark_model``
latency, as in the JAX script: the compiled forward's CUDA-graph replays,
``(T(2k) - T(k)) / k``, the median of ``repeats``. Beside it each row
carries the profiler's device-busy ms of one replay, differenced the same
way (``device_busy_ms``): the sum of the kernels' times, without the gaps
between them.

Each row carries its floors, from the bytes and multiply-adds of the JAX
script's ``floors`` held against the H100's data-sheet peaks:

  mac_floor_ms   multiply-adds at the rate of their operands: the binary
                 convs at the one-bit tensor-core rate (eight times the
                 int8 rate: what the block kernel runs), the float layers at
                 the dense bf16 rate
  hbm_floor_ms   each op's input read once and output written once, in the
                 bf16 stream (weights once, perfect fusion)
  bound_ms       the larger of the two; bound_kind says which
  pct_of_bound   bound_ms / ms (100% = at the floor)

Usage (on the card):
  python -m compute_engine_tpu_torch.scripts.section_profile [--batch 128] \\
      [--iters 40] [--repeats 7] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..device import resolve_device
from ..models.zoo import ModelSpec
from ..runtime.benchmark import benchmark_model

__all__ = ["SECTION_FILTERS", "SECTION_BLOCKS", "ROWS", "make_prefix_spec",
           "prefixes", "section_macs", "floors", "profile", "main"]

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "section_profile_h100.json")
SECTION_FILTERS = (64, 128, 256, 512)
SECTION_BLOCKS = (4, 4, 4, 4)
ROWS = ("stem_conv", "stem_depthwise", "stem_pointwise", "section_0",
        "section_1", "section_2", "section_3", "head")

# H100 SXM data-sheet peaks (dense): HBM 3.35e12 B/s; int8 1979e12 ops/s
# and bf16 989.4e12 FLOP/s, two operations to a multiply-add. The one-bit
# MMA covers eight times the int8 one's K at the same issue rate.
HBM_B_PER_S = 3.35e12
INT8_MAC_PER_S = 1979e12 / 2
BF16_MAC_PER_S = 989.4e12 / 2
ONE_BIT_MAC_PER_S = 8 * INT8_MAC_PER_S


def make_prefix_spec(stem_ops, n_sections, with_head):
    """QuickNet's first ``stem_ops`` stem ops, then ``n_sections`` sections,
    then the head if ``with_head``; layer names are the zoo QuickNet's."""

    def forward(b, x):
        f0 = SECTION_FILTERS[0]
        x = b.conv_bn(x, f0 // 4, 3, stride=2, activation="relu",
                      name="stem_conv")
        if stem_ops >= 2:
            x = b.depthwise_conv_bn(x, 3, stride=2, activation="relu",
                                    name="stem_depthwise")
        if stem_ops >= 3:
            x = b.conv_bn(x, f0, 1, name="stem_pointwise")
        for s in range(n_sections):
            filters, blocks = SECTION_FILTERS[s], SECTION_BLOCKS[s]
            if s > 0:
                x = b.max_pool(x, 2, 2)
                x = b.conv_bn(x, filters, 1, name=f"transition_{s}")
            for i in range(blocks):
                y = b.binary_conv_bn(x, filters, 3, pad_value=1,
                                     name=f"section_{s}_block_{i}")
                x = b.add(x, y)
        if with_head:
            x = b.activation(x, "relu")
            x = b.global_avg_pool(x)
            x = b.dense(x, 1000, name="head")
            x = b.softmax(x)
        return x

    name = f"qn_prefix_s{stem_ops}_{n_sections}" + ("_h" if with_head else "")
    return ModelSpec(name, forward, input_size=(224, 224), num_classes=1000)


def prefixes():
    """(label, spec) of every prefix, each one row longer than the last."""
    out = [("stem_conv", make_prefix_spec(1, 0, False)),
           ("+stem_depthwise", make_prefix_spec(2, 0, False)),
           ("+stem_pointwise", make_prefix_spec(3, 0, False))]
    out += [(f"+section_{s}", make_prefix_spec(3, s + 1, False))
            for s in range(4)]
    out.append(("+head", make_prefix_spec(3, 4, True)))
    return out


def section_macs(s, batch):
    """Binary multiply-adds of section ``s`` at ``batch`` (224x224 input)."""
    hw = 56 >> s  # 56, 28, 14, 7
    f = SECTION_FILTERS[s]
    return SECTION_BLOCKS[s] * hw * hw * f * f * 9 * batch


def floors(name, batch):
    """The floors of row ``name`` at ``batch``: ``macs`` (``binary_macs`` of
    them one-bit, the rest float), ``bytes``, ``mac_floor_s``,
    ``hbm_floor_s`` and a ``note``. The bytes and multiply-adds are the JAX
    script's: every op's input read once and output written once in the
    bf16 stream, side reads taken as fused, the input image read in bf16."""
    B = batch
    binary, note = 0, None
    if name == "stem_conv":
        macs = B * 112 * 112 * 9 * 3 * 16
        nbytes = B * (224 * 224 * 3 * 2 + 112 * 112 * 16 * 2)
        note = "the input read dominates (38.5 MB in bf16 at batch 128)"
    elif name == "stem_depthwise":
        macs = B * 56 * 56 * 9 * 16
        nbytes = B * (112 * 112 * 16 * 2 + 56 * 56 * 16 * 2)
    elif name == "stem_pointwise":
        macs = B * 56 * 56 * 16 * 64
        nbytes = B * (56 * 56 * 16 * 2 + 56 * 56 * 64 * 2)
    elif name.startswith("section_"):
        s = int(name[-1])
        hw = 56 >> s
        f = SECTION_FILTERS[s]
        binary = section_macs(s, B)
        macs = binary
        act = B * hw * hw * f * 2  # one bf16 pass over the stream
        nbytes = SECTION_BLOCKS[s] * 2 * act  # each block reads and writes
        if s > 0:
            # The transition: max pool reads the last stream and writes a
            # pooled one, the 1x1 conv reads that and writes the section's.
            prev = B * (2 * hw) * (2 * hw) * SECTION_FILTERS[s - 1] * 2
            pooled = B * hw * hw * SECTION_FILTERS[s - 1] * 2
            nbytes += prev + 2 * pooled + act
            macs += B * hw * hw * SECTION_FILTERS[s - 1] * f
        if s <= 1:
            note = "two bf16 stream passes per block are the floor"
    elif name == "head":
        nbytes = B * 7 * 7 * 512 * 2 + 512 * 1000 * 4 + B * 1000 * 4
        macs = B * 512 * 1000
    else:
        raise ValueError(f"no row {name!r}")
    return {"macs": macs, "binary_macs": binary, "bytes": nbytes,
            "mac_floor_s": binary / ONE_BIT_MAC_PER_S
            + (macs - binary) / BF16_MAC_PER_S,
            "hbm_floor_s": nbytes / HBM_B_PER_S, "note": note}


def profile(batch=128, iters=40, repeats=7, device="cuda"):
    """Each prefix's ``benchmark_model`` latency at ``batch`` (random
    weights from seed 0; ``iters`` and ``repeats`` are JAX's defaults),
    differenced into rows, with the device-busy ms of one replay beside.
    Returns the report: ``sections`` (one row per ``ROWS`` name) and
    ``whole_model``."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("section_profile reads the card's device time")
    times, busy = [], []
    for label, spec in prefixes():
        r = benchmark_model(spec, batch=batch, iters=iters, warmup=2,
                            repeats=repeats, device=device, device_busy=True)
        if r["device_busy_ms"] is None:
            raise RuntimeError(f"{label}: the profiler saw no device time")
        times.append(r["latency_ms_p50"])
        busy.append(r["device_busy_ms"])
        print(f"{label:16s} cumulative {times[-1]:8.4f} ms "
              f"({r['images_per_sec']:.0f} images/s), device busy "
              f"{busy[-1]:8.4f} ms", flush=True)
    rows, prev, prev_busy = [], 0.0, 0.0
    for name, t, b in zip(ROWS, times, busy):
        dt, prev = t - prev, t
        db, prev_busy = b - prev_busy, b
        f = floors(name, batch)
        bound_ms = max(f["mac_floor_s"], f["hbm_floor_s"]) * 1e3
        row = {"name": name, "ms": dt, "device_busy_ms": db,
               "macs": f["macs"], "bytes": f["bytes"],
               "mac_floor_ms": f["mac_floor_s"] * 1e3,
               "hbm_floor_ms": f["hbm_floor_s"] * 1e3, "bound_ms": bound_ms,
               "bound_kind": ("hbm" if f["hbm_floor_s"] >= f["mac_floor_s"]
                              else "mac"),
               "pct_of_bound": 100 * bound_ms / dt if dt > 0 else None}
        if f["binary_macs"]:
            row["binary_gmacs"] = f["binary_macs"] / 1e9
            row["pct_one_bit_peak"] = (100 * f["binary_macs"]
                                       / ONE_BIT_MAC_PER_S * 1e3 / dt
                                       if dt > 0 else None)
            if name != "section_0":
                row["includes"] = f"transition_{name[-1]}"
        if f["note"]:
            row["note"] = f["note"]
        rows.append(row)
    composite = sum(r["bound_ms"] for r in rows)
    total_macs = sum(section_macs(s, batch) for s in range(4))
    return {
        "batch": batch, "iters": iters,
        "timer": f"benchmark_model: CUDA-graph replays of {iters} and "
                 f"{2 * iters} forwards, (T(2k) - T(k)) / k, median of "
                 f"{repeats}; device_busy_ms: torch.profiler device time of "
                 "one replay of a one-forward graph",
        "sections": rows,
        "whole_model": {
            "ms": times[-1], "device_busy_ms": busy[-1],
            "images_per_sec": batch / times[-1] * 1e3,
            "binary_gmacs": total_macs / 1e9,
            "composite_bound_ms": composite,
            "pct_of_composite_bound": 100 * composite / times[-1],
        },
    }


def bad_rows(report, limit=105.0):
    """Rows whose time is not positive, or whose ``pct_of_bound`` is above
    ``limit`` (a floor above the time means the floors are wrong)."""
    return [r["name"] for r in report["sections"]
            if r["pct_of_bound"] is None or r["pct_of_bound"] > limit]


def main(argv=None):
    from ..runtime.microbench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--repeats", type=int, default=7)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    report = profile(args.batch, args.iters, args.repeats)
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, **report}
    for row in report["sections"]:
        print(json.dumps(row), flush=True)
    print("whole model:", json.dumps(report["whole_model"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", args.out, flush=True)
    bad = bad_rows(report)
    if bad:
        raise SystemExit(f"rows with no positive time or above 105% of "
                         f"their bound: {bad}")


if __name__ == "__main__":
    main()
