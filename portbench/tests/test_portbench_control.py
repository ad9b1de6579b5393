"""The control: the reference with a float8 stream, put in the program's
place, comes out not correct, while the program comes out correct.

On the CPU at a small size; on the card (marked ``card``) at each cell's
own size on three seeds, the readings ``calibrate.py`` gives for the
limits (see PERF.md).
"""

import pytest
import torch

from portbench import calibrate, spec

from portbench.tests.conftest import tiny, tiny_workload

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _fails(numbers, limits):
    return any(not numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell", ["quicknet-offline-b128",
                                  "quicknet-b1-sync"])
def test_control_fails_on_the_cpu(cell):
    torch.set_num_threads(2)
    wl = tiny_workload(cell)
    cfg, model = tiny(wl["config"])
    r = calibrate.readings(cell, 11, 0.5, "cpu", wl, cfg, model)
    limits = wl["check"]["limits"]
    assert _fails(r["control"], limits)
    assert not _fails(r["program"], limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    limits = spec.workload(cell)["check"]["limits"]
    for seed in (101, 202, 303):
        r = calibrate.readings(cell, seed, 2.0, card)
        assert r["failed"] == 0
        assert _fails(r["control"], limits), r
        assert not _fails(r["program"], limits), r
        torch.cuda.empty_cache()
