"""The readings that the check's limits are set from, on the card.

For each seed, in one process: the cell's system and inputs are built as a
run builds them, a short window runs at the cell's own load, and the rows
it sampled are compared with the reference (the program's reading); then
the reference computed with a float8 stream is put in the program's place
on the same rows (the control's reading); ``unit`` is the float32 model's
median row gap, which both are read in (see ``check.py``). Each seed
prints one JSON line.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
      [--seconds 2]

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

import torch  # noqa: E402

from portbench import check, harness, spec, system  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


def readings(cell, seed, seconds, device="cuda", workload=None,
             config=None, model=None):
    """The program's and the control's numbers for one seed (see
    ``check.numbers``)."""
    wl = workload or spec.workload(cell)
    cfg = config or spec.config(wl["config"])
    system.set_float32_flags(cfg)
    device = torch.device(device)
    traffic = spec.module("traffic", wl["kind"]).Traffic(
        cfg, wl["params"], seed, device, Tracer(False), model=model)
    window = traffic.run(seconds)
    traffic.free()
    images, served = harness.checked_rows(traffic)
    ref = check.reference_logits(cfg, traffic.weights, images)
    unit = check.scale(cfg, traffic.weights, images, ref)
    control = check.reference_logits(cfg, traffic.weights, images, "float8")
    return {"seed": seed, "rows": int(served.shape[0]),
            "failed": window["failed"], **window["metrics"], "unit": unit,
            "program": check.numbers(check.row_gaps(served, ref), unit),
            "control": check.numbers(check.row_gaps(control, ref), unit)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\\n\\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate reads the card")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
