"""``idle_pct.throughput``: the share of the profiled sub-window in which no
device operation ran, in the cells judged on a rate."""

from portbench.metrics_common import idle_pct as read  # noqa: F401
