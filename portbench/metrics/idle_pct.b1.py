"""``idle_pct.b1``: the share of the profiled sub-window in which no device
operation ran, in the cells judged on batch-1 latency."""

from portbench.metrics_common import idle_pct as read  # noqa: F401
