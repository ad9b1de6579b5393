"""The port's host health monitoring (a standard-library copy of the JAX
package's): a fake clock, and a real child process that exits."""

import subprocess
import sys
import threading

import pytest

from compute_engine_tpu.runtime import health as jhealth

from compute_engine_tpu_torch.runtime import health
from compute_engine_tpu_torch.runtime.health import (HeartbeatMonitor,
                                                     ProcessLivenessSource)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("monitor_cls", [HeartbeatMonitor,
                                         jhealth.HeartbeatMonitor])
def test_loss_and_recovery(monitor_cls):
    """The same script of heartbeats gives both packages' monitors the same
    events."""
    clock = FakeClock()
    lost, recovered = [], []
    with monitor_cls(["host0", "host1"], timeout_s=5.0, on_loss=lost.append,
                     on_recovery=recovered.append, poll_interval_s=3600,
                     clock=clock) as mon:
        assert sorted(mon.alive_hosts()) == ["host0", "host1"]
        clock.t = 4.0
        mon.heartbeat("host1")
        clock.t = 6.0  # host0 last seen at 0 -> lost; host1 at 4 -> alive
        mon.check_now()
        assert lost == ["host0"]
        assert mon.alive_hosts() == ["host1"]
        assert not mon.is_alive("host0") and mon.is_alive("host1")
        mon.heartbeat("host0")
        mon.check_now()
        assert recovered == ["host0"]
        assert sorted(mon.alive_hosts()) == ["host0", "host1"]
        mon.check_now()  # no change: no second event
        assert (lost, recovered) == (["host0"], ["host0"])


def test_unknown_host_rejected():
    with HeartbeatMonitor(["a"], poll_interval_s=3600,
                          clock=FakeClock()) as mon:
        with pytest.raises(KeyError, match="unknown host"):
            mon.heartbeat("nope")


def test_monitor_thread_polls_and_stops():
    clock = FakeClock()
    lost = threading.Event()
    mon = HeartbeatMonitor(["a"], timeout_s=1.0,
                           on_loss=lambda h: lost.set(),
                           poll_interval_s=0.01, clock=clock)
    clock.t = 2.0
    assert lost.wait(10)
    mon.close()
    assert not mon._thread.is_alive()


def test_a_child_process_that_exits_is_lost():
    """``ProcessLivenessSource`` pumps heartbeats while the child lives; when
    it exits the monitor declares it lost, and the bare pid of a process that
    is gone counts as dead too."""
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.stdin.read()"],
        stdin=subprocess.PIPE)
    lost = threading.Event()
    try:
        with HeartbeatMonitor(["w0"], timeout_s=0.4,
                              on_loss=lambda h: lost.set(),
                              poll_interval_s=0.05) as mon:
            with ProcessLivenessSource(mon, {"w0": child},
                                       poll_interval_s=0.05):
                assert not lost.wait(1.0)  # alive: heartbeats keep coming
                assert mon.is_alive("w0")
                child.stdin.close()  # the child reads EOF and exits
                assert child.wait(timeout=30) == 0
                assert lost.wait(10)
                assert mon.alive_hosts() == []
    finally:
        if child.poll() is None:
            child.kill()
    assert ProcessLivenessSource._alive(child) is False
    assert ProcessLivenessSource._alive(child.pid) is False


def test_module_is_a_standard_library_copy():
    assert health.__all__ == jhealth.__all__
    with open(health.__file__) as f:
        source = f.read()
    assert "import torch" not in source and "import jax" not in source
