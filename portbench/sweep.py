"""One point of the sweep that finds the highest rate an open-loop cell
sustains, on the card; the result is written into the cell's workload file
by hand, as a fixed number, once.

Each point is a fresh process, as a benchmark run is: it builds the cell's
system, ends set-up as a run does (``harness.settle``) and offers ``--rate``
for ``--seconds``. A rate is sustained when every request is answered and
the queue does not grow through the window: the last third's median
latency is within ``GROWTH`` of the first third's. It prints one JSON line.

  for r in 4000 6000 8000; do
    python3 portbench/sweep.py --workload <cell> --rate $r --seconds 20
  done

The benchmark's own runs never run this.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import torch  # noqa: E402

from portbench import harness, spec, system  # noqa: E402
from portbench.trace import Tracer  # noqa: E402

GROWTH = 1.5


def point(cell, rate, seconds, seed, device="cuda"):
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    system.set_float32_flags(cfg)
    params = dict(wl["params"], rate=rate)
    traffic = spec.module("traffic", wl["kind"]).Traffic(
        cfg, params, seed, torch.device(device), Tracer(False))
    harness.settle()
    with harness.GcPauses() as pauses:
        r = traffic.run(seconds)
    traffic.free()
    first, _, last = r["notes"]["p50_ms_by_third"]
    return {"rate": rate, "offered": r["attempted"], "failed": r["failed"],
            **r["metrics"], **r["notes"], "gc_pauses": pauses.summary(),
            "sustained": bool(r["failed"] == 0 and math.isfinite(last)
                              and last <= GROWTH * first)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep reads the card")
    print(json.dumps(point(args.workload, args.rate, args.seconds,
                           args.seed)), flush=True)


if __name__ == "__main__":
    main()
