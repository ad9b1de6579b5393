"""``roofline_pct.improvement``: the improvement blocks' least time over
the device time of the block kernel's tail form, the kernel that ran them,
in the profiled sub-window.

The least time of one forward's improvements is the larger of their
one-bit multiply-adds at the one-bit peak and their bytes at the HBM peak
(``counts/<model>.py`` ``improvements``); the launches seen divided by the
launches of one forward say how many forwards' improvements ran. The tail
form is its own kernel, ``tail_residual_block_kernel``; the copy of its
result into the stream is not in this share. A model without improvements,
or a run in which no kernel matches ``PATTERN``, reads nothing."""

PATTERN = "tail_residual_block_kernel"


def read(run):
    counts = run.counts()
    if not hasattr(counts, "improvements"):
        return None
    ops = [(s, e) for name, s, e in run.trace["ops"] if PATTERN in name]
    if not ops:
        return None
    launches, floor_s = counts.improvements(run.config, run.batch)
    busy_s = sum(e - s for s, e in ops) / 1e9
    return 100.0 * floor_s * (len(ops) / launches) / busy_s
