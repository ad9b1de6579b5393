"""``BENCHMARK.json`` and the files it names keep to the contract, and
every cell finds its configuration, traffic kind and metric readers."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([m["name"] for m in METRICS] + CELLS
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert spec.NAME.match(name), name
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"],
                                             entry["traffic"])
    cfg = spec.config(wl["config"])
    assert hasattr(spec.module("traffic", wl["kind"]), "Traffic")
    assert callable(spec.module("reference", cfg["reference"]).forward)
    assert callable(spec.module("counts", cfg["counts"]).per_image)
    assert set(wl["check"]["limits"]) == {"median_gap", "worst_gap",
                                          "worst_gap_abs"}
    e2e, layer = spec.cell_metrics(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in layer:
        assert callable(spec.module("metrics", m["name"]).read)


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert spec.config(c["name"])["source"] == c["source"]
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_modules_exist(name):
    """A configuration's reference and counts, and the CPU-sized model of
    its ``model`` that the CPU tests run."""
    cfg = spec.config(name)
    assert callable(spec.module("reference", cfg["reference"]).layers)
    assert callable(spec.module("counts", cfg["counts"]).per_image)
    assert callable(spec.module("tiny", cfg["model"]).tiny)


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_model_is_the_reference(name):
    """The CPU-sized model is the port's model of the reference: at the cut
    configuration, the same layer names and kernel shapes."""
    from compute_engine_tpu_torch.models import init_model

    from portbench.tests.conftest import tiny

    cfg, model = tiny(name)
    ref = spec.module("reference", cfg["reference"])
    mine = {n: tuple(shape) for n, _, shape in ref.layers(cfg)}
    assert mine == {n: tuple(p["kernel"].shape)
                    for n, p in init_model(model).items()}


def test_a_model_without_a_tiny_file_raises(monkeypatch):
    """Nothing falls back to another model: the error names the file."""
    from portbench.tests.conftest import tiny

    config = spec.config
    monkeypatch.setattr(spec, "config", lambda name: {
        **config(name), "model": "model_without_a_tiny_file"})
    missing = os.path.join("tiny", "model_without_a_tiny_file.py")
    with pytest.raises(ValueError, match=re.escape(missing)):
        tiny(CONFIGS[0])


def test_moves_is_reported_where_listed():
    """Each per-layer metric's ``moves`` is an end-to-end metric that every
    cell it lists reports."""
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            e2e, _ = spec.cell_metrics(BENCH, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "device" in layers


def test_run_seconds_fits_the_full_check():
    """2 + 14 runs a cell, run_seconds + 60 s a run, 2 x 90 s a cell to
    compile, 1200 s spare: all within 43200 s at 24 cells."""
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    cells = 24
    assert (2 + 14 * cells) * (r + 60) + cells * 180 + 1200 <= 43200


def test_no_file_under_paths_is_named_outside_the_alphabet():
    for dirpath, _, files in os.walk(spec.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert all(ch.isascii() and (ch.isalnum() or ch in "_.-/")
                       for ch in rel), rel
