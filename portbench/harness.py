"""One run of one cell: set-up, the measured window, the check, the line.

A run (see ``run.py`` for the command):
  1. reads its cell from ``BENCHMARK.json`` and ``workloads/<cell>.json``,
     and refuses to run without as many CUDA cards as the cell asks for;
  2. sets the configuration's float32 flags and builds the traffic kind's
     system and inputs from ``--seed``, warming only the cell's shapes
     (set-up, ``setup_s``, runs from the process's start to here);
  3. measures for ``--seconds``; with ``--trace 1`` it profiles a steady
     sub-window of it and reads the cell's per-layer metrics
     (``metrics/<metric>.py``) from that profile;
  4. reads the card's peak memory, frees the program's state and compares
     the sampled answers with the plain reference (``check``);
  5. refuses to print a result if JAX or the JAX package was loaded;
  6. prints each compared number beside its limit on standard error, then
     the result's JSON line as the last line of standard output.

There is no fallback: a kernel that fails fails the run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check, spec, system
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "compute_engine_tpu")
TRACE_START = 0.4    # share of the window before the profile starts
TRACE_SECONDS = 3.0  # a few seconds: hundreds of thousands of events at most

__all__ = ["main", "run_cell", "checked_rows", "measured", "settle",
           "loaded_forbidden"]


def loaded_forbidden(modules=None):
    """Top-level names in ``sys.modules`` (compared whole: the part before
    the first dot) that a run of the port may not load."""
    tops = {name.split(".", 1)[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description="one run of one portbench cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell, seed, seconds, trace, started, device="cuda",
             bench=None, workload=None, config=None, model=None):
    """The result of one run, as the dict printed. ``device``, ``bench``,
    ``workload``, ``config`` and ``model`` stand in for the card and the
    files in the tests; a run from the command line passes none of them."""
    bench = bench or spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"{cell!r} is not a workload of BENCHMARK.json")
    wl = workload or spec.workload(cell)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"{cell}: the workload file and BENCHMARK.json "
                         "name different configurations or traffic")
    cfg = config or spec.config(wl["config"])
    e2e, per_layer = spec.cell_metrics(bench, cell)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    flags = system.set_float32_flags(cfg)
    _say(f"[portbench] {cell} seed {seed} seconds {seconds} trace {trace}; "
         f"float32 flags {flags}; torch {torch.__version__}")

    # The profiled sub-window: from TRACE_START of the window, for
    # TRACE_SECONDS or nine tenths of what is left of the window, if less.
    start_s = TRACE_START * seconds
    tracer = Tracer(bool(trace), start_s,
                    min(TRACE_SECONDS, 0.9 * (seconds - start_s)),
                    cuda=device.type == "cuda")
    traffic = spec.module("traffic", wl["kind"]).Traffic(
        cfg, wl["params"], seed, device, tracer, model=model)
    settle()
    launches = system.launch_counts()
    pauses = GcPauses()
    with pauses:
        window = traffic.run(seconds)
    launches = {k: v - launches[k] for k, v in system.launch_counts().items()}
    setup_s = window["start"] - started
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traffic.free()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    images, served = checked_rows(traffic)
    ref = check.reference_logits(cfg, traffic.weights, images)
    unit = check.scale(cfg, traffic.weights, images, ref)
    correct, checks = check.judge(check.row_gaps(served, ref), unit,
                                  wl["check"]["limits"])
    checks["failed_requests"] = {"value": int(window["failed"]), "limit": 0}
    correct = correct and window["failed"] == 0
    _say(f"[check] rows checked {int(served.shape[0])}; the float32 "
         f"model's median row gap (the unit) {unit!r}")

    values = dict(window["metrics"], setup_s=setup_s)
    metrics = {m["name"]: {"value": measured(values, m["name"]),
                           "unit": m["unit"]}
               for m in e2e} if not trace else {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        reduced = tracer.reduced()
        if reduced is None:
            raise RuntimeError("the traced sub-window was never profiled")
        dev["busy_s"], dev["window_s"] = reduced["busy_s"], reduced["window_s"]
        run = _Run(cfg, wl, reduced, tracer)
        for m in per_layer:
            value = spec.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": [[short_name(n), v]
                           for n, v in reduced["device_ops"]],
            "idle_gaps": reduced["idle_gaps"]}
    notes = dict(window.get("notes", {}), gc_pauses=pauses.summary(),
                 setup_steps_s=traffic.setup_steps,
                 kernel_launches_in_window=launches,
                 forwards_in_window=window["forwards"])
    for note, value in notes.items():
        _say(f"[portbench] {note}: {value}")
    result["checks"] = checks
    return result


def measured(values, name):
    """The value of the end-to-end metric ``name`` among what the traffic
    measured: under its whole name, or else under its part before the
    first dot (``latency_p95_ms.b1`` is the traffic's ``latency_p95_ms``,
    held to a bound of its own in the cells that list it)."""
    return values[name] if name in values else values[name.split(".", 1)[0]]


def settle():
    """Ends set-up: what it made lives as long as the process, so it leaves
    the collector's way, and a full collection in the window walks only
    what the window made (a walk over torch's objects stalled an open-loop
    window's requests for 230-300 ms on the card)."""
    gc.collect()
    gc.freeze()


def short_name(name, limit=100):
    """A kernel's name without its return type, anonymous namespaces and
    parameter list, at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, None
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            cut = i
    return (name if cut is None else name[:cut])[:limit]


class GcPauses:
    """The collector's pauses while the block runs (count, total and
    longest ms), from ``gc.callbacks``."""

    def __init__(self):
        self.pauses, self._t = [], None

    def _hook(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((time.perf_counter() - self._t) * 1e3)

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)

    def summary(self):
        return {"count": len(self.pauses), "total_ms": sum(self.pauses),
                "max_ms": max(self.pauses, default=0.0)}


def checked_rows(traffic):
    """``(images, served)``: every checked row's input image (float32 NHWC
    on the device) and the logits the timed path served for it."""
    groups = traffic.checked()
    images = torch.cat([g[0].reshape(-1, *g[0].shape[-3:]) for g in groups])
    served = torch.cat([g[1].reshape(-1, g[1].shape[-1]).float()
                        for g in groups])
    return images, served


class _Run:
    """What a per-layer metric's reader reads: the configuration, the
    workload, the reduced profile (``trace``), the forwards completed in
    the profiled sub-window (``calls``) and the batch of one forward."""

    def __init__(self, config, workload, reduced, tracer):
        self.config, self.workload, self.trace = config, workload, reduced
        self.calls = tracer.calls_traced
        p = workload["params"]
        self.batch = int(p.get("batch", p.get("batch_size", 1)))

    def counts(self):
        return spec.module("counts", self.config["counts"])


def main(argv, started):
    args = _parse(argv)
    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    chips = int(entry["chips"]) if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"[portbench] needs {chips} CUDA card(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      started, bench=bench)
    found = loaded_forbidden()
    if found:
        _say(f"[portbench] the run loaded {found}; no result")
        return 3
    for name, c in result["checks"].items():
        _say(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    _say(f"[check] correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
