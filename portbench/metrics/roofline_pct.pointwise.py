"""``roofline_pct.pointwise``: the 1x1 binary convs' least time over the
device time of the binary GEMM's kernel, which ran them, in the profiled
sub-window.

The least time of one forward's 1x1 convs is the larger of their one-bit
multiply-adds at the one-bit peak and their bytes at the HBM peak
(``counts/<model>.py`` ``pointwise``: the packed signs read once, the bf16
residual read once, the bf16 output written once, the packed filters
once); the launches seen divided by the launches of one forward say how
many forwards' 1x1 convs ran. A model without them, or a run in which no
kernel matches ``PATTERN``, reads nothing."""

PATTERN = "bgemm_kernel"


def read(run):
    counts = run.counts()
    if not hasattr(counts, "pointwise"):
        return None
    ops = [(s, e) for name, s, e in run.trace["ops"] if PATTERN in name]
    if not ops:
        return None
    launches, floor_s = counts.pointwise(run.config, run.batch)
    busy_s = sum(e - s for s, e in ops) / 1e9
    return 100.0 * floor_s * (len(ops) / launches) / busy_s
