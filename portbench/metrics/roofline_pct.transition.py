"""``roofline_pct.transition``: the dense blocks' float transitions' least
time over the device time of the kernel that ran them, in the profiled
sub-window.

A transition is a 1x1 conv of the stream to the channels its reduction
gives, then a 2x2/2 average pool. The least time of one forward's
transitions is the larger of their bytes at the HBM peak (the bf16 stream
read once, the pooled bf16 stream written once, the bf16 filters and the
float32 biases once) and their multiply-adds at the bf16 peak (counted with
the conv before the pool, as it runs); the widths come from the
configuration through ``counts/binary_densenet45.py`` ``_blocks``. The
launches seen divided by the launches of one forward (one a transition)
say how many forwards' transitions ran. A configuration without
transitions (no ``reductions``), or a run in which no kernel matches
``PATTERN``, reads nothing."""

from portbench import peaks, spec

PATTERN = "transition_conv_pool_kernel"


def transitions(config, batch):
    """``(launches, floor_s, bytes)`` of one forward's transitions at
    ``batch``."""
    blocks = spec.module("counts", "binary_densenet45")._blocks(config)
    nbytes = macs = 0
    for h, w, c, n, c_out in blocks[:-1]:
        c_in = c + n * config["growth_rate"]
        nbytes += (batch * h * w * c_in * 2
                   + batch * (h // 2) * (w // 2) * c_out * 2
                   + c_in * c_out * 2 + c_out * 4)
        macs += batch * h * w * c_in * c_out
    floor_s = max(nbytes / peaks.HBM_BYTES, macs / peaks.BF16_MACS)
    return len(blocks) - 1, floor_s, nbytes


def read(run):
    if "reductions" not in run.config:
        return None
    launches, floor_s, _ = transitions(run.config, run.batch)
    ops = [(s, e) for name, s, e in run.trace["ops"] if PATTERN in name]
    if not ops or not launches:
        return None
    busy_s = sum(e - s for s, e in ops) / 1e9
    return 100.0 * floor_s * (len(ops) / launches) / busy_s
