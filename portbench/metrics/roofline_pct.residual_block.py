"""``roofline_pct.residual_block``: the binary residual blocks' least time
over the device time of the kernels that ran them in the profiled
sub-window.

The least time of one forward's blocks is the larger of their one-bit
multiply-adds at the one-bit peak and their bytes (the bf16 stream read and
written once, the packed filters once) at the HBM peak
(``counts/<model>.py`` ``residual_blocks``); the launches seen divided by
the launches of one forward say how many forwards' blocks ran. A model with
no such blocks, or a run in which no kernel matches ``PATTERN``, reads
nothing."""

PATTERN = "residual_block_kernel"


def read(run):
    counts = run.counts()
    if not hasattr(counts, "residual_blocks"):
        return None
    ops = [(s, e) for name, s, e in run.trace["ops"] if PATTERN in name]
    if not ops:
        return None
    launches, floor_s = counts.residual_blocks(run.config, run.batch)
    busy_s = sum(e - s for s, e in ops) / 1e9
    return 100.0 * floor_s * (len(ops) / launches) / busy_s
