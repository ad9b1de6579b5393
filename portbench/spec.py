"""What a cell is made of, found by name: ``BENCHMARK.json`` at the
checkout's root, ``workloads/<cell>.json``, ``configs/<config>.json``, and
the modules ``traffic/<kind>.py``, ``metrics/<metric>.py``,
``reference/<model>.py``, ``counts/<model>.py`` and (for the CPU tests)
``tiny/<model>.py`` beside this file.

Nothing here knows a cell, a model or a metric by name: a new one is a new
file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

__all__ = ["benchmark", "workload", "config", "module", "cell_metrics",
           "NAME", "UNIT", "HERE", "ROOT"]


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    """``BENCHMARK.json`` of the checkout."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name):
    """The cell's file: its configuration, traffic kind, parameters and
    correctness limits."""
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    path = os.path.join(HERE, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no workload {name!r} ({path})")
    return _json(path)


def config(name):
    if not NAME.match(name):
        raise ValueError(f"not a configuration name: {name!r}")
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def module(kind, name):
    """``<kind>/<name>.py`` beside this file, loaded by path (a metric's
    name may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise ValueError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reported(metric, cell):
    listed = metric.get("workloads")
    return listed is None or cell in listed


def cell_metrics(bench, cell):
    """``(end_to_end, per_layer)``: the metric entries that ``cell``
    reports. An end-to-end metric without ``workloads`` is reported by every
    cell; a per-layer one without it by every cell that reports the
    end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"] if _reported(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reported(m, cell) and m["moves"] in names]
    return e2e, layer
