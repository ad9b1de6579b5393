"""The traffic kinds' schedules and statistics, against fake systems."""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from compute_engine_tpu_torch.runtime.serving import ServingStats
from portbench import spec, stats
from portbench.trace import Tracer

open_loop = spec.module("traffic", "open_loop")


def test_schedule_is_one_set_in_orders_drawn_from_the_seed():
    a = open_loop.schedule(1000, 2.0, seed=1)
    b = open_loop.schedule(1000, 2.0, seed=2)
    assert len(a) == len(b) == 2000 and a[0] == b[0] == 0
    assert not np.array_equal(a, b)
    gaps_a = np.sort(np.diff(np.append(a, 2.0)))
    gaps_b = np.sort(np.diff(np.append(b, 2.0)))
    assert np.allclose(gaps_a, gaps_b)
    assert np.array_equal(a, open_loop.schedule(1000, 2.0, seed=1))


class FakeEngine:
    """Answers each request ``delay`` seconds after it is submitted, from
    one thread of its own; stalls the submitter once for ``stall`` seconds
    at request ``stall_at``; never answers requests in ``lost``."""

    def __init__(self, delay=0.002, stall_at=None, stall=0.0, lost=()):
        self.delay, self.stall_at, self.stall = delay, stall_at, stall
        self.lost = set(lost)
        self.n = 0
        self.stats = ServingStats()  # one batch a request, 1 ms forward
        self.pending = queue.Queue()
        threading.Thread(target=self._answer, daemon=True).start()

    def _answer(self):
        while True:
            at, fut, value = self.pending.get()
            time.sleep(max(0.0, at - time.perf_counter()))
            self.stats.requests += 1
            self.stats.batches += 1
            self.stats.forward_ms += 1.0
            fut.set_result(value)

    def submit(self, image):
        i = self.n
        self.n += 1
        if i == self.stall_at:
            time.sleep(self.stall)
        fut = Future()
        if i not in self.lost:
            self.pending.put((time.perf_counter() + self.delay, fut,
                              np.full(4, float(image[0]))))
        return fut


def _traffic(engine, rate=400, drain_s=0.5):
    t = open_loop.Traffic.__new__(open_loop.Traffic)
    t.p = {"rate": rate, "sample": 16, "drain_s": drain_s}
    t.seed, t.tracer, t.engine = 5, Tracer(False), engine
    t.pool = np.arange(8, dtype=np.float32)[:, None]
    return t


def test_latency_runs_from_due_time():
    """A 100 ms stall at the submitter delays every request due during it:
    their latency counts the wait, though the engine answers in 2 ms."""
    engine = FakeEngine(delay=0.002, stall_at=100, stall=0.1)
    r = _traffic(engine).run(1.0)
    assert r["attempted"] == 400 and r["failed"] == 0
    assert r["metrics"]["latency_p95_ms"] > 40
    calm = _traffic(FakeEngine(delay=0.002)).run(1.0)
    assert calm["metrics"]["latency_p50_ms"] < 20
    assert r["metrics"]["latency_p95_ms"] > 3 * \
        calm["metrics"]["latency_p95_ms"]


def test_failures_count_and_rank_last():
    lost = range(0, 400, 10)  # 10% never answered
    r = _traffic(FakeEngine(delay=0.001, lost=lost), drain_s=0.2).run(1.0)
    assert r["failed"] == 40
    assert r["metrics"]["latency_p95_ms"] == float("inf")
    assert np.isfinite(r["metrics"]["latency_p50_ms"])


def test_serving_stats_are_read_over_the_whole_window():
    """The engine's counters grow over the window and its drain, and the
    run reports them per batch: every answered request is one batch of
    the fake engine, with a forward of 1 ms."""
    engine = FakeEngine(delay=0.001)
    engine.stats.batches = engine.stats.requests = 7  # before the window
    r = _traffic(engine).run(0.5)
    assert r["failed"] == 0 and r["forwards"] == r["attempted"] == 200
    assert r["notes"]["requests_per_batch"] == 1.0
    assert r["notes"]["serving_ms_per_batch"]["forward_ms"] == 1.0
    assert r["notes"]["serving_ms_per_batch"]["stack_ms"] == 0.0


def test_checked_rows_are_the_requests_own():
    t = _traffic(FakeEngine(delay=0.001))
    t.run(0.5)
    t.device = "cpu"
    t.scale = 1.0
    for images, rows in t.checked(group=4):
        assert np.array_equal(images[:, 0].numpy(), rows[:, 0].numpy())


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([1.0, float("inf")], 95) == float("inf")
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(100)
    for seed in range(400):
        r = stats.Reservoir(10, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        counts[r.items] += 1
        assert len(set(r.items)) == 10
    assert counts.min() > 15 and counts.max() < 70  # about 40 each
    a, b = stats.Reservoir(3, 9), stats.Reservoir(3, 9)
    for i in range(50):
        a.offer(lambda i=i: i)
        b.offer(lambda i=i: i)
    assert a.items == b.items
