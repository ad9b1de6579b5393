"""The traced run: a profile of a steady sub-window of the measured window,
reduced in memory to what the per-layer metrics and ``breakdown`` read.

``Tracer`` starts ``torch.profiler`` (host and CUDA activities) at
``start_s`` into the window and stops it ``length_s`` after its start
returned (a start holds the interpreter lock for about 0.4 s, once 3.3 s,
on the card), from whichever thread drives the traffic; the harness's own
host spans (``span``) are ``record_function`` ranges, on only in a traced
run. Device operations are
the profiler's device events (kernels, copies, memsets) that are not
annotations; nothing is written to disk.

``reduce`` takes plain tuples, so that its arithmetic is tested on
synthetic events: the sub-window's length, the seconds in which at least
one device operation ran (overlaps counted once), device time by operation
name, and the idle gaps, each named by the innermost host span open at its
middle and summed by name.
"""

from __future__ import annotations

import contextlib
import time

WINDOW_SPAN = "portbench/traced_window"
TOP = 10

__all__ = ["Tracer", "reduce", "union_seconds", "WINDOW_SPAN"]


class Tracer:
    """Profiles ``[start_s, start_s + length_s)`` of the window when
    ``enabled``; ``tick(elapsed)`` is called by the traffic's driving loop
    and returns at once when there is nothing to do."""

    def __init__(self, enabled, start_s=0.0, length_s=0.0, cuda=True):
        self.enabled, self.cuda = enabled, cuda
        self.start_s, self.length_s = start_s, length_s
        self.state = "idle" if enabled else "off"
        self.calls = 0            # forwards completed, kept by the traffic
        self.calls_traced = None  # forwards completed inside the sub-window
        self.result = None
        self._prof = self._range = None
        self._calls0 = self._on_at = 0

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def tick(self, elapsed):
        if self.state == "idle" and elapsed >= self.start_s:
            self._start()
        elif (self.state == "on"
              and time.perf_counter() >= self._on_at + self.length_s):
            self._stop()

    def close(self):
        """Stops a profile still running when the window ends early."""
        if self.state == "on":
            self._stop()

    def _start(self):
        import torch

        act = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            act.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=act)
        self._prof.start()
        self._calls0 = self.calls
        self._range = torch.profiler.record_function(WINDOW_SPAN)
        self._range.__enter__()
        self._on_at = time.perf_counter()  # length_s runs from here
        self.state = "on"

    def _stop(self):
        import torch

        self._range.__exit__(None, None, None)
        self.calls_traced = self.calls - self._calls0
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self.state = "done"

    def reduced(self):
        """The reduced profile (see ``reduce``), read once after the window
        has closed; ``None`` when no profile was taken."""
        if self.state != "done":
            return None
        if self.result is None:
            self.result = reduce(*events(self._prof))
            self._prof = None
        return self.result


def events(prof):
    """``(device_ops, host_spans, window)`` of a stopped profiler, as
    ``(name, start_ns, end_ns)`` tuples, read from its raw events."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((name, start, end))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif e.is_user_annotation():
            host.append((name, start, end))
    if window is None:
        raise RuntimeError("the traced window's span is missing")
    return device, host, window


def union_seconds(intervals):
    """Seconds covered by ``(start_ns, end_ns)`` intervals, overlaps once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def _gaps(intervals, lo, hi):
    """Idle ``(start, end)`` stretches of ``[lo, hi)`` between the
    (clipped) intervals."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def _host_at(spans, points):
    """For each time in ``points``, the name of the innermost (latest
    starting) host span open at it, by one sweep over the spans."""
    import heapq

    events = sorted([(s, 0, i) for i, (_, s, _) in enumerate(spans)]
                    + [(e, 1, i) for i, (_, _, e) in enumerate(spans)])
    order = sorted(range(len(points)), key=points.__getitem__)
    out = ["no harness span"] * len(points)
    heap, ended, k = [], set(), 0
    for q in order:
        t = points[q]
        while k < len(events) and (events[k][0] < t or (
                events[k][0] == t and events[k][1] == 0)):
            _, kind, i = events[k]
            if kind == 0:
                heapq.heappush(heap, (-spans[i][1], i))
            else:
                ended.add(i)
            k += 1
        while heap and heap[0][1] in ended:
            heapq.heappop(heap)
        if heap:
            out[q] = spans[heap[0][1]][0]
    return out


def reduce(device_ops, host_spans, window):
    """``{"busy_s", "window_s", "device_ops", "idle_gaps"}`` of the device
    operations clipped to ``window`` (``(start_ns, end_ns)``):
    ``device_ops`` the ``TOP`` names by device seconds, ``idle_gaps`` the
    ``TOP`` host spans by idle seconds under them, each as ``[name,
    seconds]``; ``ops`` holds the clipped operations themselves."""
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in device_ops
           if e > lo and s < hi]
    intervals = [(s, e) for _, s, e in ops]
    by_name = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
    idle = {}
    gaps = _gaps(intervals, lo, hi)
    names = _host_at(list(host_spans), [(s + e) // 2 for s, e in gaps])
    for (s, e), name in zip(gaps, names):
        idle[name] = idle.get(name, 0) + (e - s)

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": union_seconds(intervals), "window_s": (hi - lo) / 1e9,
            "device_ops": top(by_name), "idle_gaps": top(idle), "ops": ops}
