"""The compared numbers on synthetic rows: a swapped answer fails whatever
the float32 model's gap, and half of the rows wrong fail the median."""

import pytest
import torch

from portbench import check

LIMITS = {"median_gap": 1.2, "worst_gap": 2.0, "worst_gap_abs": 0.6}


def _rows(n=64, classes=100, noise=0.01):
    g = torch.Generator().manual_seed(3)
    ref = torch.randn(n, classes, generator=g, dtype=torch.float64) + 5.0
    return ref, ref + noise * torch.randn(n, classes, generator=g,
                                          dtype=torch.float64)


@pytest.mark.parametrize("unit", [0.06, 0.72])
def test_sound_rows_pass(unit):
    ref, out = _rows()
    gaps = check.row_gaps(out, ref)
    correct, checks = check.judge(gaps, unit, LIMITS)
    assert correct, checks


def test_a_swapped_row_fails_at_a_large_unit():
    """Two images' answers lie about 1.4 spreads apart: at a unit of 0.72
    that is under ``worst_gap``'s 2.0, so ``worst_gap_abs`` must catch it."""
    ref, out = _rows()
    out = out[[1, 0, *range(2, out.shape[0])]]
    gaps = check.row_gaps(out, ref)
    assert float(gaps.max()) == pytest.approx(2 ** 0.5, rel=0.2)
    correct, checks = check.judge(gaps, 0.72, LIMITS)
    assert checks["worst_gap"]["value"] <= LIMITS["worst_gap"]
    assert checks["worst_gap_abs"]["value"] > LIMITS["worst_gap_abs"]
    assert not correct


def test_half_the_rows_wrong_fail_the_median():
    ref, out = _rows()
    out[::2] = out[::2] + 0.1 * out[::2].std()
    gaps = check.row_gaps(out, ref)
    sound = check.numbers(gaps[1::2], 0.01)["median_gap"]
    assert check.numbers(gaps, 0.01)["median_gap"] > 2 * sound


def test_a_nan_fails_every_number():
    ref, out = _rows()
    out[3, 7] = float("nan")
    correct, checks = check.judge(check.row_gaps(out, ref), 0.1, LIMITS)
    assert not correct
    assert all(c["value"] != c["value"] for c in checks.values())
