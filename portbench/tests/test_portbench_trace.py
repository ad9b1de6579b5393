"""The idle and busy arithmetic of the traced run, on synthetic events."""

import pytest

from portbench import trace
from portbench.metrics_common import idle_pct


def test_union_counts_overlaps_once():
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40)]) == 30e-9
    assert trace.union_seconds([]) == 0


def test_reduce_clips_names_and_gaps():
    ops = [("k1", -5, 10), ("k2", 5, 30), ("k1", 50, 60), ("late", 95, 130)]
    spans = [("portbench/call", 0, 100), ("portbench/to_host", 30, 55)]
    r = trace.reduce(ops, spans, (0, 100))
    assert r["window_s"] == pytest.approx(100e-9)
    # busy: [0, 30) + [50, 60) + [95, 100)
    assert r["busy_s"] == pytest.approx(45e-9)
    assert r["device_ops"][0] == ["k2", pytest.approx(25e-9)]
    assert dict((k, v) for k, v in r["device_ops"])["k1"] == \
        pytest.approx(20e-9)
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    # [30, 50) lies under to_host (innermost); [60, 95) under call only.
    assert gaps["portbench/to_host"] == pytest.approx(20e-9)
    assert gaps["portbench/call"] == pytest.approx(35e-9)


def test_idle_share():
    class Run:
        trace = trace.reduce([("k", 0, 25), ("k", 50, 75)], [], (0, 100))

    assert idle_pct(Run) == pytest.approx(50.0)


def test_gap_outside_every_span():
    r = trace.reduce([("k", 0, 10)], [("a", 0, 10)], (0, 20))
    assert r["idle_gaps"] == [["no harness span", pytest.approx(10e-9)]]


def test_top_is_bounded():
    ops = [(f"k{i}", 2 * i, 2 * i + 1) for i in range(30)]
    r = trace.reduce(ops, [], (0, 100))
    assert len(r["device_ops"]) == trace.TOP
    assert len(r["idle_gaps"]) <= trace.TOP


def test_breakdown_names_are_short():
    from portbench.harness import short_name

    assert short_name("void (anonymous namespace)::residual_block_kernel"
                      "<__nv_bfloat16, true, 8>(__nv_bfloat16 const*, int)"
                      ) == "residual_block_kernel<__nv_bfloat16, true, 8>"
    assert short_name("memcpy128") == "memcpy128"
    assert len(short_name("k<" + "x" * 500 + ">(int)")) == 100
