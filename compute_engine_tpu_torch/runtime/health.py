"""Host health monitoring for multi-host serving.

LCE has no failure handling beyond TFLite status codes; a serving
deployment over several hosts needs real detection. ``HeartbeatMonitor``
tracks per-host liveness from pluggable heartbeat sources and fires callbacks
on loss and recovery, so that a server over several hosts can drop a dead one
from its batch-sharding map. ``ProcessLivenessSource`` feeds it from the
liveness of worker processes. Standard library only; a copy of
``compute_engine_tpu.runtime.health``.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["HeartbeatMonitor", "ProcessLivenessSource"]


class HeartbeatMonitor:
    """Tracks host liveness from heartbeat timestamps.

    Args:
      hosts: iterable of host ids.
      timeout_s: a host is declared lost if no heartbeat within this window.
      on_loss / on_recovery: callbacks (host_id) -> None, invoked from the
        monitor thread.
      poll_interval_s: check cadence.
    """

    def __init__(self, hosts, timeout_s=5.0, on_loss=None, on_recovery=None,
                 poll_interval_s=0.2, clock=time.monotonic):
        self._clock = clock
        self._timeout = timeout_s
        self._on_loss = on_loss
        self._on_recovery = on_recovery
        self._poll = poll_interval_s
        self._lock = threading.Lock()
        now = clock()
        self._last_seen = {h: now for h in hosts}
        self._alive = {h: True for h in hosts}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def heartbeat(self, host):
        """Record a heartbeat (called by RPC handlers / agents)."""
        with self._lock:
            if host not in self._last_seen:
                raise KeyError(f"unknown host {host!r}")
            self._last_seen[host] = self._clock()

    def alive_hosts(self):
        with self._lock:
            return [h for h, a in self._alive.items() if a]

    def is_alive(self, host):
        with self._lock:
            return self._alive[host]

    def check_now(self):
        """Force one liveness sweep (also used by tests with fake clocks)."""
        now = self._clock()
        events = []
        with self._lock:
            for h, seen in self._last_seen.items():
                alive = (now - seen) <= self._timeout
                if alive != self._alive[h]:
                    self._alive[h] = alive
                    events.append((h, alive))
        for h, alive in events:
            cb = self._on_recovery if alive else self._on_loss
            if cb is not None:
                cb(h)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self):
        while not self._stop.wait(self._poll):
            self.check_now()


class ProcessLivenessSource:
    """Heartbeat source driven by real OS process liveness.

    Pumps ``monitor.heartbeat(host)`` while the host's worker process is
    alive; a dead process (exit, crash, kill) stops the pump and the monitor
    declares the host lost after its timeout — subprocess exit becomes a
    loss event with no simulation involved.

    Args:
      monitor: the HeartbeatMonitor to feed.
      procs: dict host_id -> subprocess.Popen (or bare pid int).
    """

    def __init__(self, monitor, procs, poll_interval_s=0.1):
        self._monitor = monitor
        self._procs = dict(procs)
        self._poll = poll_interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _alive(proc) -> bool:
        if hasattr(proc, "poll"):
            return proc.poll() is None
        try:
            os.kill(int(proc), 0)
            return True
        except (OSError, ProcessLookupError):
            return False

    def _loop(self):
        while not self._stop.wait(self._poll):
            for host, proc in self._procs.items():
                if self._alive(proc):
                    self._monitor.heartbeat(host)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
