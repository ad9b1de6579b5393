"""Arithmetic that several per-layer metrics' readers share."""


def idle_pct(run):
    """Per cent of the profiled sub-window with no device operation."""
    t = run.trace
    if not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
