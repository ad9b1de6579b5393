"""``mfu``: the whole forward's share of the card's peak over the profiled
sub-window: the forwards completed there times the least time their
multiply-adds take at the data-sheet peaks (``counts/<model>.py``; one-bit
multiply-adds at the one-bit rate, float ones at the bf16 rate), over the
sub-window's seconds."""

from portbench import peaks


def read(run):
    if not run.calls or not run.trace["window_s"]:
        return None
    c = run.counts().per_image(run.config)
    floor = peaks.floor_s(c["binary_macs"] * run.batch,
                          c["float_macs"] * run.batch)
    return 100.0 * floor * run.calls / run.trace["window_s"]
