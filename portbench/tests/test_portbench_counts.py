"""The multiply-adds and floors that ``mfu`` and the roofline divide by."""

import pytest

from portbench import peaks, spec


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


def _macs_from_layers(name):
    """Multiply-adds from the reference's own layer list and the output
    sizes of a SAME-padded forward, walked independently of the counts."""
    cfg = spec.config(name)
    ref = spec.module("reference", cfg["reference"])
    h, w = cfg["input_size"]
    binary = fl = 0
    size = {"h": h, "w": w}

    def out(stride):
        size["h"], size["w"] = -(-size["h"] // stride), -(-size["w"] // stride)
        return size["h"] * size["w"]

    for lname, kind, shape in ref.layers(cfg):
        if kind == "dense":
            fl += shape[0] * shape[1]
            continue
        kh, kw, cin, cout = shape
        if name == "quicknet":
            stride = 2 if lname in ("stem_conv", "stem_depthwise") else 1
            if lname.startswith("transition_"):
                out(2)  # the max pool before it
            n = out(stride)
        else:
            if lname == "stem_conv":
                n = out(2)
                out(2)  # the max pool after it
            elif lname.startswith("shortcut_"):
                n = (-(-size["h"] // 2)) * (-(-size["w"] // 2))
            else:
                down = (lname.endswith("_block_0")
                        and lname != "stage_0_block_0")
                n = out(2 if down else 1)
        macs = n * kh * kw * cin * (1 if kind == "depthwise" else cout)
        if kind == "binary":
            binary += macs
        else:
            fl += macs
    return binary, fl


@pytest.mark.parametrize("name", ["quicknet", "birealnet18"])
def test_counts_match_the_layers(name):
    cfg, counts = _counts(name)
    c = counts.per_image(cfg)
    assert (c["binary_macs"], c["float_macs"]) == _macs_from_layers(name)


def test_peaks():
    assert peaks.ONE_BIT_MACS == 8 * peaks.INT8_MACS
    assert peaks.floor_s(peaks.ONE_BIT_MACS, peaks.BF16_MACS) == 2.0
