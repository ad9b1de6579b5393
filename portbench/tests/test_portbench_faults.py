"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven on the CPU at a small size (the look for a card
skipped), with the port's forward broken in one of the ways an inference
cell can be: half of each batch left out, its rows the mean of the rest;
one answer altered where it is produced (its logits moved by one class);
two answers swapped, each request served another image's row.
The state and the exchange between chips that a training or sharded cell
could lose do not exist here.
"""

import time

import pytest
import torch

from portbench import harness, spec

from portbench.tests.conftest import tiny, tiny_workload

BENCH = spec.benchmark()


def _half_left_out(out):
    half = out.shape[0] // 2
    out = out.clone()
    out[half:] = out[:half].mean(dim=0)
    return out


def _one_altered(out):
    out = out.clone()
    out[0] = out[0].roll(1)
    return out


def _two_swapped(out):
    return out[[1, 0, *range(2, out.shape[0])]]


FAULTS = {"half_left_out": _half_left_out, "one_altered": _one_altered,
          "two_swapped": _two_swapped}
ROWS_OF_A_BATCH = ("half_left_out", "two_swapped")


def _run(cell, monkeypatch, fault=None):
    from compute_engine_tpu_torch.runtime.interpreter import Interpreter

    if fault is not None:
        forward = Interpreter._forward
        monkeypatch.setattr(Interpreter, "_forward",
                            lambda self, x: FAULTS[fault](forward(self, x)))
    wl = tiny_workload(cell)
    if "rate" in wl["params"]:  # full batches, every request checked
        wl["params"].update(rate=1500, max_delay_ms=200, sample=4096)
    cfg, model = tiny(wl["config"])
    return harness.run_cell(cell, 2 ** 31 + 17, 1.0, 0, time.perf_counter(),
                            device="cpu", bench=BENCH, workload=wl,
                            config=cfg, model=model)


CASES = [(w["name"], f) for w in BENCH["workloads"] for f in FAULTS
         if not (f in ROWS_OF_A_BATCH
                 and spec.workload(w["name"])["params"].get("batch") == 1)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    result = _run(cell, monkeypatch, fault)
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_intact_run_is_correct(cell, monkeypatch):
    """An unbroken run is correct and reports each of the cell's end-to-end
    metrics, under the names ``BENCHMARK.json`` gives them."""
    torch.set_num_threads(2)
    result = _run(cell, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["failed_requests"] == {"value": 0, "limit": 0}
    e2e, _ = spec.cell_metrics(BENCH, cell)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert all(m["value"] > 0 for m in result["metrics"].values())
