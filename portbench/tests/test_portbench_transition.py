"""The ``roofline_pct.transition`` reader: BinaryDenseNet-45's three float
transitions' floor from the configuration's widths, the share on synthetic
reduced profiles, and nothing read without the kernel or without
transitions."""

import pytest

from portbench import peaks, spec, trace

CONFIG = "binary_densenet45"
TRANSITION = spec.module("metrics", "roofline_pct.transition")

# The name the profiler gives one of the kernel's instantiations.
KERNEL = ("void (anonymous namespace)::transition_conv_pool_kernel<5>("
          "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
          "__nv_bfloat16*, (anonymous namespace)::Shape)")
DENSE = ("void (anonymous namespace)::residual_block_kernel"
         "<__nv_bfloat16, false, false, 8>(__nv_bfloat16 const*)")


class _Run:
    """What a reader reads, over a synthetic reduced profile."""

    def __init__(self, config, ops, window=(0, 10 ** 6), batch=128):
        self.config = spec.config(config)
        self.trace = trace.reduce(ops, [], window)
        self.batch = batch

    def counts(self):
        return spec.module("counts", self.config["counts"])


def test_densenet45_transition_floor():
    """Three transitions a forward, bound by bytes at b128: the bf16 stream
    read once (56x56x448, 28x28x928, 14x14x1152), the pooled bf16 stream
    written once (28x28x160, 14x14x256, 7x7x288), the bf16 filters and
    float32 biases once: 653.6 MB, 0.1951 ms; the 60.9 G multiply-adds,
    counted with the conv before the pool, take 0.1232 ms at the bf16
    peak."""
    cfg = spec.config(CONFIG)
    launches, floor_s, nbytes = TRANSITION.transitions(cfg, 128)
    shapes = ((56, 448, 160), (28, 928, 256), (14, 1152, 288))
    want = sum(128 * hw * hw * c * 2 + 128 * (hw // 2) ** 2 * co * 2
               + c * co * 2 + co * 4 for hw, c, co in shapes)
    macs = sum(128 * hw * hw * c * co for hw, c, co in shapes)
    assert launches == 3
    assert nbytes == want == 653_572_864
    assert floor_s == pytest.approx(nbytes / peaks.HBM_BYTES)
    assert floor_s == pytest.approx(0.1951e-3, rel=1e-3)
    assert macs == pytest.approx(60.94e9, rel=1e-3)
    assert macs / peaks.BF16_MACS == pytest.approx(0.1232e-3, rel=1e-3)


def test_transition_share_reads_the_kernel_only():
    """One forward's three launches, 0.1 ms each among the dense layers'
    kernels: the floor over their 0.3 ms; a forward and a third seen, the
    floor scales with the launches."""
    _, floor_s, _ = TRANSITION.transitions(spec.config(CONFIG), 128)
    ops, t = [], 0
    for i in range(4):
        ops.append((DENSE, t, t + 50_000))
        ops.append((KERNEL, t + 50_000, t + 150_000))
        t += 150_000
    assert TRANSITION.read(_Run(CONFIG, ops[:6])) == pytest.approx(
        100 * floor_s / 0.3e-3)
    assert TRANSITION.read(_Run(CONFIG, ops)) == pytest.approx(
        100 * floor_s * (4 / 3) / 0.4e-3)


def test_transition_share_reads_nothing_without_its_kernel_or_transitions():
    assert TRANSITION.read(_Run(CONFIG, [(DENSE, 0, 100)])) is None
    for config in ("quicknet", "birealnet18", "meliusnet22"):
        assert TRANSITION.read(_Run(config, [(KERNEL, 0, 100)])) is None
