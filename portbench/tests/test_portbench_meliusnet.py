"""MeliusNet-22's own numbers: the ``roofline_pct.improvement`` reader and
the block-kernel roofline on synthetic reduced profiles, the floors of its
38 binary convs and of its 19 improvements, its layers against the
reference's; on the card (marked ``card``), the launches of one b128
forward through the port's normal path."""

import pytest

from portbench import peaks, spec, trace

CONFIG = "meliusnet22"
IMPROVEMENT = spec.module("metrics", "roofline_pct.improvement")
BLOCKS = spec.module("metrics", "roofline_pct.residual_block")

# The names the profiler gives the block kernel's instantiations.
TAIL = ("void (anonymous namespace)::tail_residual_block_kernel"
        "<__nv_bfloat16, true, 8>(__nv_bfloat16 const*, unsigned int const*)")
DENSE = ("void (anonymous namespace)::residual_block_kernel"
         "<__nv_bfloat16, false, true, 8>(__nv_bfloat16 const*)")


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
    return counts.residual_blocks(cfg, 128), counts.improvements(cfg, 128)


def test_improvement_share_reads_the_tail_form_only():
    """The floor of the improvements seen (19 a forward) over the device
    time of the tail form's kernel alone; the block-kernel roofline reads
    both forms, its 38-launch floor over their time together."""
    (blocks, block_floor), (tails, tail_floor) = _floors()
    # one forward's 38 launches: each tail form 20 us, each dense 10 us
    ops, t = [], 0
    for i in range(blocks):
        name, dt = (TAIL, 20_000) if i % 2 else (DENSE, 10_000)
        ops.append((name, t, t + dt))
        t += dt
    run = _Run(CONFIG, ops)
    assert IMPROVEMENT.read(run) == pytest.approx(
        100 * tail_floor / (tails * 20e-6))
    assert BLOCKS.read(run) == pytest.approx(
        100 * block_floor / (tails * 30e-6))
    # half a forward's improvements seen: the floor scales with them
    half = [op for op in ops if op[0] == TAIL][:tails // 2 + 1]
    assert IMPROVEMENT.read(_Run(CONFIG, half)) == pytest.approx(
        IMPROVEMENT.read(run))


def test_improvement_share_reads_nothing_without_its_kernel_or_counts():
    assert IMPROVEMENT.read(_Run(CONFIG, [(DENSE, 0, 100)])) is None
    assert IMPROVEMENT.read(_Run("binary_densenet45", [(TAIL, 0, 100)])) \
        is None
    assert IMPROVEMENT.read(_Run("quicknet", [(TAIL, 0, 100)])) is None


def test_meliusnet22_floors():
    """38 binary convs a forward, 19 of them improvements, bound by bytes
    at batch 128: the C_in-channel bf16 input read once (an improvement's
    residual, its last 64 channels, among them), the 64 new channels
    written once, the packed filters and the (64, 9) int32 ``tap_delta``
    tables once: 2.660 GB and 0.794 ms, of which the improvements 1.474 GB
    and 0.440 ms; their one-bit multiply-adds (4.689 G an image) take
    0.0758 ms at the one-bit peak."""
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    (blocks, block_floor), (tails, tail_floor) = _floors()
    stages = ((56, 64, 4), (28, 160, 5), (14, 224, 4), (7, 256, 6))
    convs = [(hw, c + 64 * i + 64 * tail, tail) for hw, c, n in stages
             for i in range(n) for tail in (0, 1)]

    def nbytes(tail_only):
        return sum(128 * hw * hw * (c + 64) * 2
                   + 64 * 9 * (-(-c // 32)) * 4 + 64 * 9 * 4
                   for hw, c, tail in convs if tail or not tail_only)

    assert (blocks, tails) == (38, 19)
    assert nbytes(False) == pytest.approx(2.660e9, rel=1e-3)
    assert nbytes(True) == pytest.approx(1.474e9, rel=1e-3)
    assert block_floor == pytest.approx(nbytes(False) / peaks.HBM_BYTES)
    assert tail_floor == pytest.approx(nbytes(True) / peaks.HBM_BYTES)
    assert block_floor == pytest.approx(0.794e-3, rel=1e-3)
    assert tail_floor == pytest.approx(0.440e-3, rel=1e-3)
    macs = sum(128 * hw * hw * c * 64 * 9 for hw, c, _ in convs)
    assert macs == 128 * counts.per_image(cfg)["binary_macs"]
    assert counts.per_image(cfg)["binary_macs"] == 4_689_248_256
    assert macs / peaks.ONE_BIT_MACS == pytest.approx(0.0758e-3, rel=2e-3)


def test_counted_layers_are_the_references():
    """The counts' binary convs are the reference's, in order: the input
    channels of each kernel, every other one an improvement."""
    cfg = spec.config(CONFIG)
    counts = spec.module("counts", cfg["counts"])
    ref = spec.module("reference", cfg["reference"])
    binary = [(name, shape[2]) for name, kind, shape in ref.layers(cfg)
              if kind == "binary"]
    assert [(c, tail) for _, _, c, tail in counts._layers(cfg)] == [
        (c, "improvement" in name) for name, c in binary]


@pytest.mark.card
def test_b128_forward_launches(card):
    """Through the port's normal path (``system.build``: ``convert_model``,
    ``Interpreter`` with ``kernel="auto"``, one CUDA graph), each b128
    forward launches the block kernel 38 times and the binary GEMM never,
    and makes 19 concatenations and 19 tail adds, all in place and
    fused."""
    import torch

    from compute_engine_tpu_torch.models.builder import add_tail, concat

    from portbench import images, system

    cfg = spec.config(CONFIG)
    system.set_float32_flags(cfg)
    _, interp, _ = system.build(cfg, 2147480301, card)
    h, w = cfg["input_size"]
    x = images.float_images(128, h, w, cfg["channels"],
                            system.generator(2147480301, "inputs", card),
                            card)

    def counted():
        return dict(system.launch_counts(), concat=concat.in_place,
                    add_tail=add_tail.fused)

    interp(x).cpu()  # compiles: warm-up and capture are not counted
    before = counted()
    forwards = 3
    for _ in range(forwards):
        out = interp(x).cpu()
    after = counted()
    per_forward = {k: (after[k] - before[k]) / forwards for k in after}
    assert per_forward == {"residual_block": 38, "bgemm": 0,
                           "bgemm_splitk": 0, "concat": 19, "add_tail": 19}
    assert out.shape == (128, cfg["num_classes"])
    assert bool(torch.isfinite(out).all())
