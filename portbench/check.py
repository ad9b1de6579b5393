"""What decides ``correct``: the served logits against the plain reference.

Each checked answer is one row of logits that the timed path produced,
compared with the reference's logits for the same input (``reference/
<model>.py``, computed from the same raw weights and images, in the
configuration's stream dtype). A row's gap is

    || program_i - reference_i || / S,
    S = sqrt(mean_j || reference_j - mean_k(reference_k) ||^2)

over the rows checked: the distance from the reference's answer in units
of how far the reference's answers to different images lie apart. With
random weights most of every row's logits is the same for every image, so
a gap measured against a row's own size would let one image's answer pass
for another's.

How far a rounding travels through a binary network depends on its
weights: from seed to seed the gaps of any two computations that round
differently rise and fall together (a sign that a rounding flips changes
its conv's sums by 2, and the next layers' signs with them). So each gap is
read against the float32 model's: the reference computed with a float32
stream, whose median gap from the bfloat16 reference (``scale``) sets the
unit. Three numbers are compared with their limits, which the cell's
workload file holds (set from readings on the card, see PERF.md):
``median_gap``, the upper median row's gap in that unit, which a lower
precision of the whole stream fails (the upper one, so that with half of
the rows wrong it reads a wrong one); ``worst_gap``, the largest row's gap
in that unit, which an answer altered or left out fails; ``worst_gap_abs``,
the largest row's gap in units of the spread alone, which an answer
swapped for another image's fails whatever the float32 model's gap (two
images' answers lie about 1.4 spreads apart). A NaN fails all three.

The reference runs after the window has closed and the program's state is
freed, in blocks of rows, with the parameters on the device.
"""

from __future__ import annotations

import torch

from . import spec

BLOCK_ROWS = 64

__all__ = ["row_gaps", "numbers", "scale", "judge", "reference_logits",
           "BLOCK_ROWS"]


def row_gaps(out, ref):
    """Gap of every row of ``out`` from ``ref`` (both (rows, classes)), in
    units of the reference rows' spread about their mean row."""
    out, ref = out.double(), ref.double()
    spread = (ref - ref.mean(dim=0, keepdim=True)).norm(dim=1)
    return (out - ref).norm(dim=1) / spread.square().mean().sqrt()


def numbers(gaps, unit):
    """The compared numbers of a run's row gaps (see the module's text)."""
    gaps = gaps.double()
    if bool(torch.isnan(gaps).any()):
        nan = float("nan")
        return {"median_gap": nan, "worst_gap": nan, "worst_gap_abs": nan}
    upper_median = gaps.sort().values[gaps.numel() // 2]
    return {"median_gap": float(upper_median) / unit,
            "worst_gap": float(gaps.max()) / unit,
            "worst_gap_abs": float(gaps.max())}


def scale(config, params, images, ref):
    """The float32 model's median row gap from the reference ``ref``."""
    f32 = reference_logits(config, params, images, "float32")
    return float(row_gaps(f32, ref).median())


def judge(gaps, unit, limits):
    """``(correct, checks)``: each number beside its limit; correct when
    every one is at most its limit (a NaN is not)."""
    checks = {name: {"value": value, "limit": float(limits[name])}
              for name, value in numbers(gaps, unit).items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def device_params(params, device):
    """The parameter tree with every tensor on ``device``."""
    return {name: {k: ({kk: vv.to(device) for kk, vv in v.items()}
                       if isinstance(v, dict) else v.to(device))
                   for k, v in layer.items()}
            for name, layer in params.items()}


def reference_logits(config, params, images, stream_dtype=None):
    """The reference's logits of ``images`` (float32 NHWC on the device,
    any number of rows), in blocks of ``BLOCK_ROWS``; ``stream_dtype``
    defaults to the configuration's."""
    ref = spec.module("reference", config["reference"])
    dtype = stream_dtype or config["compute_dtype"]
    p = device_params(params, images.device)
    with torch.no_grad():
        return torch.cat([ref.forward(p, config, images[i:i + BLOCK_ROWS],
                                      dtype).cpu()
                          for i in range(0, images.shape[0], BLOCK_ROWS)])
