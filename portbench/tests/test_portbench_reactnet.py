"""ReActNet-A's own numbers: the ``roofline_pct.pointwise`` reader and the
block-kernel roofline on synthetic reduced profiles, the floors of its 9
stride-1 3x3 convs and of its 13 1x1 convs, its layers against the
reference's; on the card (marked ``card``), the launches of one b128
forward through the port's normal path."""

import pytest

from portbench import peaks, spec, trace

CONFIG = "reactnet_a"
POINTWISE = spec.module("metrics", "roofline_pct.pointwise")
BLOCKS = spec.module("metrics", "roofline_pct.residual_block")

# The names the profiler gives the kernels.
REACT = ("void (anonymous namespace)::react_residual_block_kernel"
         "<__nv_bfloat16, 8>(__nv_bfloat16 const*, unsigned int const*)")
GEMM = ("void (anonymous namespace)::bgemm_kernel<2, 8, 1>(unsigned int "
        "const*, unsigned int const*, int, int)")


class _Run:
    """What a reader reads, over a synthetic reduced profile."""

    def __init__(self, config, ops, window=(0, 10 ** 6), batch=128):
        self.config = spec.config(config)
        self.trace = trace.reduce(ops, [], window)
        self.batch = batch

    def counts(self):
        return spec.module("counts", self.config["counts"])


def _floors():
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    return counts.residual_blocks(cfg, 128), counts.pointwise(cfg, 128)


def test_pointwise_share_reads_the_gemm_only():
    """The floor of the 1x1 convs seen (13 a forward) over the device time
    of the binary GEMM's kernel alone; the block-kernel roofline reads the
    ReActNet form, its 9-launch floor over its time."""
    (blocks, block_floor), (gemms, gemm_floor) = _floors()
    ops, t = [], 0
    for name, n, dt in ((REACT, blocks, 30_000), (GEMM, gemms, 20_000)):
        for _ in range(n):
            ops.append((name, t, t + dt))
            t += dt
    run = _Run(CONFIG, ops)
    assert POINTWISE.read(run) == pytest.approx(
        100 * gemm_floor / (gemms * 20e-6))
    assert BLOCKS.read(run) == pytest.approx(
        100 * block_floor / (blocks * 30e-6))
    # half a forward's 1x1 convs seen: the floor scales with them
    half = [op for op in ops if op[0] == GEMM][:7]
    assert POINTWISE.read(_Run(CONFIG, half)) == pytest.approx(
        POINTWISE.read(run))


def test_pointwise_share_reads_nothing_without_its_kernel_or_counts():
    assert POINTWISE.read(_Run(CONFIG, [(REACT, 0, 100)])) is None
    assert POINTWISE.read(_Run("meliusnet22", [(GEMM, 0, 100)])) is None
    assert POINTWISE.read(_Run("quicknet", [(GEMM, 0, 100)])) is None


def test_reactnet_a_floors():
    """9 stride-1 3x3 convs and 13 1x1 convs a forward, bound by bytes at
    batch 128. The 3x3s: the bf16 input read once, the bf16 output written
    once, the packed filters, ``tap_delta``, the shifts and the RPReLUs
    once: 0.2386 ms. The 1x1s: the packed signs and the bf16 residual read
    once, the bf16 output written once, the packed filters once: 0.3640
    ms. The one-bit multiply-adds, 4.817 G an image, take 0.0779 ms."""
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    (blocks, block_floor), (gemms, gemm_floor) = _floors()
    widths = [32] + cfg["block_widths"]
    sizes, hw = [], 112
    for c, c_out in zip(widths, widths[1:]):
        stride = 2 if c_out not in (c, 64) else 1
        sizes.append((hw, c, c_out, stride))
        hw //= stride
    block_bytes = sum(2 * 128 * hw * hw * c * 2 + c * 9 * (c // 32) * 4
                      + c * 9 * 4 + 16 * c
                      for hw, c, _, stride in sizes if stride == 1)
    gemm_bytes = 0
    for hw, c, c_out, stride in sizes:
        rows = 128 * (hw // stride) ** 2
        gemm_bytes += (rows * (c // 32) * 4 + rows * c * 2 + rows * c_out * 2
                       + c_out * (c // 32) * 4)
    assert (blocks, gemms) == (9, 13)
    assert block_floor == pytest.approx(block_bytes / peaks.HBM_BYTES)
    assert gemm_floor == pytest.approx(gemm_bytes / peaks.HBM_BYTES)
    assert block_floor == pytest.approx(0.2386e-3, rel=1e-3)
    assert gemm_floor == pytest.approx(0.3640e-3, rel=1e-3)
    c = counts.per_image(cfg)
    assert (c["binary_macs"], c["float_macs"]) == (4_816_896_000, 11_862_016)
    assert 128 * c["binary_macs"] / peaks.ONE_BIT_MACS == pytest.approx(
        0.0779e-3, rel=2e-3)


def test_counted_blocks_are_the_references():
    """The counts' blocks are the reference's, in order: input and output
    channels and stride; four at stride 2."""
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    ref = spec.module("reference", cfg["reference"])
    assert [(c, c_out, stride) for _, _, c, c_out, stride
            in counts._blocks(cfg)] == ref.blocks(cfg)
    assert [s for _, _, s in ref.blocks(cfg)].count(2) == 4


@pytest.mark.card
def test_b128_forward_launches(card):
    """Through the port's normal path (``system.build``: ``convert_model``,
    ``Interpreter`` with ``kernel="auto"``, one CUDA graph), each b128
    forward launches the block kernel 9 times, the binary GEMM 13 times
    (one a 1x1 conv, the pairs one each) and never split over K."""
    import torch

    from portbench import images, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    _, interp, _ = system.build(cfg, 2147480302, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(2147480302, "inputs", card),
                            card)
    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = system.launch_counts()
    forwards = 3
    for _ in range(forwards):
        out = interp(x).cpu()
    after = system.launch_counts()
    per_forward = {k: (after[k] - before[k]) / forwards for k in after}
    assert per_forward == {"residual_block": 9, "bgemm": 13,
                           "bgemm_splitk": 0}
    assert out.shape == (128, cfg["num_classes"])
    assert bool(torch.isfinite(out).all())
