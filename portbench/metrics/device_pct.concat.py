"""``device_pct.concat``: the share of the profiled sub-window's busy device
time spent in the model builder's channel concatenations (``torch.cat``,
whose copies run as the kernels that ``PATTERN`` matches).

A configuration whose counts have no ``concats`` reads nothing; one that has
them reads 0.0 when no copy ran, as a stream concatenated in place would.
"""

from portbench.trace import union_seconds

PATTERN = "CatArrayBatchedCopy"


def read(run):
    if not hasattr(run.counts(), "concats") or not run.trace["busy_s"]:
        return None
    ops = [(s, e) for name, s, e in run.trace["ops"] if PATTERN in name]
    return 100.0 * union_seconds(ops) / run.trace["busy_s"]
