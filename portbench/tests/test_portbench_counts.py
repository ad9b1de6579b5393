"""The multiply-adds and floors that ``mfu`` and the roofline divide by."""

import pytest

from portbench import peaks, spec

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _counts(name):
    cfg = spec.config(name)
    return cfg, spec.module("counts", cfg["counts"])


@pytest.mark.parametrize("batch", [1, 128])
def test_quicknet_matches_section_profile_floors(batch):
    from compute_engine_tpu_torch.scripts import section_profile as sp

    cfg, counts = _counts("quicknet")
    rows = [sp.floors(r, batch) for r in sp.ROWS]
    c = counts.per_image(cfg)
    assert c["binary_macs"] * batch == sum(r["binary_macs"] for r in rows)
    assert c["float_macs"] * batch == sum(r["macs"] - r["binary_macs"]
                                          for r in rows)


def test_quicknet_block_floor():
    """16 launches a forward, bound by bytes: 0.2305 ms at batch 128."""
    cfg, counts = _counts("quicknet")
    launches, floor_s = counts.residual_blocks(cfg, 128)
    assert launches == 16
    assert floor_s == pytest.approx(0.2305e-3, rel=1e-3)


def test_birealnet18_block_floor():
    """13 stride-1 blocks a forward, bound by bytes: the bf16 stream read
    and written once, the packed filters and the (C_out, 9) int32
    ``tap_delta`` table once each, 682.1 MB and 0.2036 ms at batch 128; their
    one-bit multiply-adds take 0.0243 ms at the one-bit peak."""
    cfg, counts = _counts("birealnet18")
    launches, floor_s = counts.residual_blocks(cfg, 128)
    blocks = ([(56, 64)] * 4 + [(28, 128)] * 3 + [(14, 256)] * 3
              + [(7, 512)] * 3)
    nbytes = sum(2 * 128 * hw * hw * f * 2 + f * 9 * (f // 32) * 4 + f * 9 * 4
                 for hw, f in blocks)
    macs = sum(128 * hw * hw * f * f * 9 for hw, f in blocks)
    assert launches == 13
    assert nbytes == pytest.approx(682.1e6, rel=1e-4)
    assert floor_s == pytest.approx(nbytes / peaks.HBM_BYTES)
    assert floor_s == pytest.approx(0.2036e-3, rel=1e-3)
    assert macs / peaks.ONE_BIT_MACS == pytest.approx(0.0243e-3, rel=2e-3)


# What one output element of each plain layer function multiplies and adds:
# a conv's, a binary conv's and a dense layer's kernel holds the output
# channels on its last axis, a depthwise kernel (kh, kw, C, 1) on its third.
LAYER_FUNCTIONS = {"conv": ("float", -1), "binary_conv": ("binary", -1),
                   "depthwise": ("float", 2), "dense": ("float", -1)}


def _macs_of_a_forward(name, monkeypatch):
    """Multiply-adds of one full-size image through the reference's own
    ``forward``, independent of ``counts/``: each plain layer function of
    ``reference/plain.py`` is wrapped to record its output's elements times
    the kernel's weights per output channel. A layer function called inside
    another counts only in the outer one."""
    import math

    import torch

    from portbench.reference import plain

    cfg = spec.config(name)
    ref = spec.module("reference", cfg["reference"])
    totals = {"binary": 0, "float": 0}
    depth = 0

    def counted(fn, kind, channel_axis):
        def layer(x, p, *args, **kwargs):
            nonlocal depth
            depth += 1
            try:
                y = fn(x, p, *args, **kwargs)
            finally:
                depth -= 1
            if depth == 0:
                shape = p["kernel"].shape
                totals[kind] += (y.numel() * math.prod(shape)
                                 // shape[channel_axis])
            return y
        return layer

    for fname, (kind, channel_axis) in LAYER_FUNCTIONS.items():
        monkeypatch.setattr(plain, fname, counted(getattr(plain, fname), kind,
                                                  channel_axis))
    params = ref.make_params(cfg, 0, "cpu")
    h, w = cfg["input_size"]
    with torch.no_grad():
        ref.forward(params, cfg, torch.zeros(1, h, w, cfg["channels"]),
                    "float32")
    return totals["binary"], totals["float"]


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_the_layers(name, monkeypatch):
    cfg, counts = _counts(name)
    c = counts.per_image(cfg)
    assert (c["binary_macs"], c["float_macs"]) == _macs_of_a_forward(
        name, monkeypatch)


def test_peaks():
    assert peaks.ONE_BIT_MACS == 8 * peaks.INT8_MACS
    assert peaks.floor_s(peaks.ONE_BIT_MACS, peaks.BF16_MACS) == 2.0
