"""BinaryDenseNet-45's own numbers: the ``device_pct.concat`` reader on
synthetic reduced profiles, the floor of its dense layers on the block
kernel, the concatenations its counts give against those the reference's
forward makes; on the card (marked ``card``), the launches of one b128
forward through the port's normal path."""

import pytest
import torch

from portbench import peaks, spec, trace

CONFIG = "binary_densenet45"
CONCAT = spec.module("metrics", "device_pct.concat")


class _Run:
    """What a reader reads, over a synthetic reduced profile."""

    def __init__(self, config, ops, window=(0, 100)):
        self.config = spec.config(config)
        self.trace = trace.reduce(ops, [], window)

    def counts(self):
        return spec.module("counts", self.config["counts"])


def test_concat_share_of_busy_time():
    """Copies overlapping other work count once, over the busy time."""
    ops = [("residual_block_kernel<bf16>", 0, 40),
           ("CatArrayBatchedCopy_contig<bf16>", 40, 60),
           ("CatArrayBatchedCopy_contig<bf16>", 55, 70),
           ("cudnn_conv", 80, 100)]
    # busy: [0, 70) + [80, 100) = 90; copies: [40, 70) = 30.
    assert CONCAT.read(_Run(CONFIG, ops)) == pytest.approx(100 * 30 / 90)


def test_concat_share_is_zero_without_copies():
    """A configuration that counts concatenations reads 0.0 when none ran,
    as a stream concatenated in place would."""
    ops = [("residual_block_kernel<bf16>", 0, 40)]
    assert CONCAT.read(_Run(CONFIG, ops)) == 0.0


def test_concat_share_is_none_without_concats():
    ops = [("CatArrayBatchedCopy<bf16>", 0, 40)]
    assert CONCAT.read(_Run("quicknet", ops)) is None


def test_binary_densenet45_block_floor():
    """40 dense layers a forward, bound by bytes: the C_in-channel bf16
    input read once, the 64 new channels written once, the packed filters
    once, no residual; 3.35 GB and 1.0 ms at batch 128; their one-bit
    multiply-adds (6.38 G an image) take 0.103 ms at the one-bit peak."""
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    launches, floor_s = counts.residual_blocks(cfg, 128)
    layers = [(hw, c + 64 * i) for hw, c, n in ((56, 64, 6), (28, 160, 12),
                                                (14, 256, 14), (7, 288, 8))
              for i in range(n)]
    nbytes = sum(128 * hw * hw * (c + 64) * 2 + 64 * 9 * (c // 32) * 4
                 for hw, c in layers)
    macs = sum(128 * hw * hw * c * 64 * 9 for hw, c in layers)
    assert launches == 40
    assert nbytes == pytest.approx(3.351e9, rel=1e-3)
    assert floor_s == pytest.approx(nbytes / peaks.HBM_BYTES)
    assert floor_s == pytest.approx(1.0003e-3, rel=1e-3)
    assert macs == 128 * counts.per_image(cfg)["binary_macs"]
    assert macs / peaks.ONE_BIT_MACS == pytest.approx(0.1032e-3, rel=2e-3)


def test_concats_match_the_reference_forward(monkeypatch):
    """The counts' concatenations are those of the reference's own forward
    on one full-size image: one a dense layer, each reading its inputs and
    writing its output once, in bf16."""
    cfg = spec.config(CONFIG)
    ref = spec.module("reference", cfg["reference"])
    made = []
    cat = torch.cat

    def counted(xs, dim=0):
        y = cat(xs, dim=dim)
        made.append(y.numel())
        return y

    params = ref.make_params(cfg, 0, "cpu")
    h, w = cfg["input_size"]
    monkeypatch.setattr(torch, "cat", counted)
    with torch.no_grad():
        ref.forward(params, cfg, torch.zeros(1, h, w, cfg["channels"]),
                    "float32")
    monkeypatch.undo()
    counts = spec.module("counts", cfg["counts"])
    assert counts.concats(cfg, 1) == (len(made), sum(2 * 2 * n for n in made))
    assert len(made) == sum(cfg["layers_per_block"]) == 40
    launches, nbytes = counts.concats(cfg, 128)
    assert launches == 40
    assert nbytes == pytest.approx(6.699e9, rel=1e-3)


@pytest.mark.card
def test_b128_forward_launches(card):
    """Through the port's normal path (``system.build``: ``convert_model``,
    ``Interpreter`` with ``kernel="auto"``, one CUDA graph), each b128
    forward launches the block kernel 40 times, the binary GEMM never, and
    the model builder's concatenation 40 times."""
    from compute_engine_tpu_torch.models.builder import concat

    from portbench import images, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    _, interp, _ = system.build(cfg, 2147480101, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(2147480101, "inputs", card),
                            card)
    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = dict(system.launch_counts(), concat=concat.launches)
    forwards = 3
    for _ in range(forwards):
        out = interp(x).cpu()
    after = dict(system.launch_counts(), concat=concat.launches)
    per_forward = {k: (after[k] - before[k]) / forwards for k in after}
    assert per_forward == {"residual_block": 40, "bgemm": 0,
                           "bgemm_splitk": 0, "concat": 40}
    assert out.shape == (128, cfg["num_classes"])
    assert bool(torch.isfinite(out).all())
