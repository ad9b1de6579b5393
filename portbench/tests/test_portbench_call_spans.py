"""The program's call spans in the traced breakdown: on synthetic reduced
profiles, each keeps a name of its own among ``trace.TOP`` beside the
harness's; on the card (marked ``card``), a traced batch-1 run puts the
call's idle under them and not under the harness's ``portbench/call``."""

import time

import pytest

from portbench import trace

# The spans an ``Interpreter`` call records while a profiler runs.
CALL_SPANS = ("interpreter/call", "interpreter/as_tensor", "compiled/lock",
              "compiled/input_copy", "compiled/replay", "compiled/output")
HARNESS = ("portbench/call", "portbench/to_host", "no harness span")


def test_every_call_span_keeps_its_own_idle_gap_name():
    """Idle under each of the six call spans and under each of the
    harness's three names: all nine are among the ``TOP`` kept, each with
    its own idle seconds."""
    assert len(CALL_SPANS) + len(HARNESS) <= trace.TOP
    ops, spans, at = [], [], 0
    for i, name in enumerate(CALL_SPANS + HARNESS[:2]):
        ops.append(("k", at, at + 10))
        spans.append((name, at + 10, at + 20 + i))  # idle: 10 + i ns
        at += 20 + i
    ops.append(("k", at, at + 1))
    r = trace.reduce(ops, spans, (0, at + 12))  # the last 11 ns: no span
    got = dict(r["idle_gaps"])
    want = {n: (10 + i) / 1e9 for i, n in enumerate(CALL_SPANS + HARNESS[:2])}
    want["no harness span"] = 11 / 1e9
    assert got == pytest.approx(want)


@pytest.mark.card
def test_b1_call_idle_lies_under_the_program_spans(card):
    """A traced batch-1 run with a 3 s profile keeps at most 0.1 s of its
    idle under the harness's ``portbench/call``, the call's idle lying
    under the program's spans instead."""
    from portbench import harness

    r = harness.run_cell("quicknet-b1-sync", 2147480001, 8.0, 1,
                         time.perf_counter(), device=card)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] == pytest.approx(3.0, abs=0.05)
    gaps = dict(r["breakdown"]["idle_gaps"])
    program = sum(v for k, v in gaps.items() if k in CALL_SPANS)
    assert gaps.get("portbench/call", 0.0) <= 0.1, gaps
    assert program > gaps.get("portbench/call", 0.0), gaps
