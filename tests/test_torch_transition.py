"""The BinaryDenseNets' float transition in one kernel
(``kernels/transition.py``), on the CPU: the plain version is the packed
builder's chain bit for bit, the builders' ``transition`` is the conv and
the pool it stands for, the wrapper refuses what the kernel does not take,
no other model's 1x1 conv is one it takes, the filter is prepared once for
the transitions alone, the launch plan is the kernel's, and a launch is
counted once a replay under a graph's ledger. The kernel itself runs on the
card only (``tests/test_torch_transition_card.py``, ``chip_smoke.py
--transition-only``).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.interop import layers_from_numpy
from compute_engine_tpu_torch.kernels import counts, debug_checks
from compute_engine_tpu_torch.kernels import transition as tr
from compute_engine_tpu_torch.models import (FloatBuilder, PackedBuilder,
                                             convert_model, get_model,
                                             init_model, packed_apply,
                                             prepare_runtime_arrays, zoo)
from compute_engine_tpu_torch.models import layers as L
from compute_engine_tpu_torch.models.builder import _Base
from compute_engine_tpu_torch.models.shapes import transition_layers
from compute_engine_tpu_torch.parallel.partition import ShardedBuilder

SEED = 2147625025


def _inputs(batch, hw=(8, 8), c=64, c_out=32, prefix=0, seed=SEED):
    """A bf16 stream (the first ``c`` channels of a buffer ``prefix``
    channels wider, with exact +0.0 and -0.0 entries), a folded 1x1 kernel
    and a bias."""
    rng = np.random.default_rng(seed)
    buf = rng.normal(0, 1, (batch, *hw, c + prefix)).astype(np.float32)
    buf.reshape(-1)[::97] = 0.0
    buf.reshape(-1)[1::89] = -0.0
    kernel = rng.normal(0, (2.0 / c) ** 0.5, (1, 1, c, c_out))
    bias = rng.normal(0, 0.5, c_out)
    x = torch.from_numpy(buf).to(torch.bfloat16)[..., :c]
    return (x, torch.from_numpy(kernel.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


def _chain(x, kernel, bias):
    """The packed builder's float conv, then its average pool, as it ran
    the transitions before the kernel (``PackedBuilder.conv_bn``,
    ``_Base.avg_pool``)."""
    y = L.conv2d(x.to(torch.bfloat16), kernel, (1, 1), "SAME")
    y = L.apply_activation(y + bias, None).to(torch.bfloat16)
    return L.avg_pool(y, (2, 2), (2, 2), "VALID")


@pytest.mark.parametrize("batch, hw, c, c_out, prefix", [
    (1, (2, 2), 16, 32, 0), (2, (8, 8), 64, 32, 0), (3, (4, 6), 48, 96, 0),
    (2, (8, 8), 96, 64, 32), (2, (14, 14), 1152, 288, 0)])
def test_plain_version_is_the_chain(batch, hw, c, c_out, prefix):
    x, kernel, bias = _inputs(batch, hw, c, c_out, prefix)
    want = _chain(x, kernel, bias)
    assert want.shape == (batch, hw[0] // 2, hw[1] // 2, c_out)
    assert want.dtype == torch.bfloat16
    for got in (tr.transition_conv_pool_plain(x, kernel, bias),
                tr.transition_conv_pool(x, kernel, bias)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case, error", [
    ("odd H", ValueError), ("odd W", ValueError),
    ("channel stride 2", ValueError), ("channels first", ValueError),
    ("C_in 24", ValueError), ("relu", ValueError), ("C_out 48", ValueError),
    ("C_out 320", ValueError), ("3x3 kernel", ValueError),
    ("C_in mismatch", ValueError), ("float32", TypeError),
    ("uint8", TypeError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    x, kernel, bias = _inputs(1)
    activation = None
    if case == "odd H":
        x = _inputs(1, hw=(7, 8))[0]
    elif case == "odd W":
        x = _inputs(1, hw=(8, 5))[0]
    elif case == "channel stride 2":
        x = _inputs(1, c=128)[0][..., ::2]
    elif case == "channels first":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case == "C_in 24":
        x, kernel, bias = _inputs(1, c=24)
    elif case == "relu":
        activation = "relu"
    elif case == "C_out 48":
        x, kernel, bias = _inputs(1, c_out=48)
    elif case == "C_out 320":
        x, kernel, bias = _inputs(1, c_out=320)
    elif case == "3x3 kernel":
        kernel = kernel.expand(3, 3, *kernel.shape[2:]).contiguous()
    elif case == "C_in mismatch":
        kernel = _inputs(1, c=32)[1]
    elif case == "float32":
        x = x.float()
    else:
        x = x.to(torch.uint8)
    with pytest.raises(error):
        tr.transition_conv_pool(x, kernel, bias, activation=activation)


def _tiny_spec(name):
    """A zoo model at 32x32 with 16 classes, its full widths and depths."""
    return zoo.ModelSpec(name, functools.partial(getattr(zoo, name),
                                                 num_classes=16),
                         input_size=(32, 32), num_classes=16)


def _images(batch=2, size=32, seed=SEED):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (batch, size, size, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def densenets():
    """Tiny DenseNet-28, -37 and -45: the spec, its float parameters and
    its runtime layers prepared with the spec."""
    out = {}
    for name in ("binary_densenet28", "binary_densenet37",
                 "binary_densenet45"):
        spec = _tiny_spec(name)
        params = init_model(spec, seed=3, randomize_bn=True)
        layers = prepare_runtime_arrays(convert_model(spec, params), spec)
        out[name] = (spec, params, layers)
    return out


def _checking(builder_cls, seen):
    """``builder_cls`` whose ``transition`` is held, at each call, to its
    conv and pool run as the two layers."""
    class Checking(builder_cls):
        def transition(self, x, filters, *, name):
            got = super().transition(x, filters, name=name)
            want = self.avg_pool(self.conv_bn(x, filters, 1, name=name), 2,
                                 2)
            seen.append((name, got.dtype, torch.equal(got, want)))
            return got

    return Checking


@pytest.mark.parametrize("name", ["binary_densenet28", "binary_densenet37",
                                  "binary_densenet45"])
def test_builders_transition_is_conv_bn_then_avg_pool(densenets, name,
                                                      monkeypatch):
    """``_Base.transition`` (the float forward's) and
    ``PackedBuilder.transition`` on the CPU equal ``conv_bn`` followed by
    ``avg_pool``, bit for bit, at each of the three transitions; the packed
    one goes through the kernel's wrapper (its plain version here), with
    the filter prepared at load, and its logits equal those of the same
    forward with the routing off."""
    spec, params, layers = densenets[name]
    x = _images()
    seen = []
    with torch.inference_mode():
        spec.forward(_checking(FloatBuilder, seen)(
            {k: {kk: torch.as_tensor(vv) if not isinstance(vv, dict)
                 else {a: torch.as_tensor(b) for a, b in vv.items()}
                 for kk, vv in v.items()} for k, v in params.items()}), x)
    assert seen == [(f"transition_{i}", torch.float32, True)
                    for i in range(3)]

    run = layers_from_numpy(layers, "cpu")
    calls, wrapper = [], tr.transition_conv_pool

    def recording(*a, **kw):
        calls.append(kw.get("filter_bf16"))
        return wrapper(*a, **kw)

    monkeypatch.setattr(tr, "transition_conv_pool", recording)
    seen.clear()
    with torch.inference_mode():
        got = spec.forward(_checking(PackedBuilder, seen)(
            run, return_logits=True), x)
    assert seen == [(f"transition_{i}", torch.bfloat16, True)
                    for i in range(3)]
    assert len(calls) == 3
    for i, filt in enumerate(calls):
        assert torch.equal(filt, tr.transition_filter(
            run[f"transition_{i}"]["kernel"]))
    monkeypatch.setattr(tr, "transition_supported", lambda *a, **kw: False)
    want = packed_apply(spec, run, x, return_logits=True, device="cpu")
    assert len(calls) == 3
    assert torch.equal(got, want)


def test_a_float32_or_int8_stream_takes_the_chain(densenets, monkeypatch):
    """A float32 stream, and an int8 pipeline's transitions, never reach
    the wrapper."""
    spec, params, layers = densenets["binary_densenet45"]
    calls = []
    monkeypatch.setattr(tr, "transition_conv_pool",
                        lambda *a, **kw: calls.append(1))
    packed_apply(spec, layers_from_numpy(layers, "cpu"), _images(),
                 compute_dtype=torch.float32, device="cpu")
    assert not calls
    from compute_engine_tpu_torch.models import calibrate_model

    x = _images().numpy()
    ranges = calibrate_model(spec, params, [x], with_outputs=True,
                             device="cpu")
    layers8 = prepare_runtime_arrays(convert_model(spec, params, *ranges),
                                     spec)
    assert "transition_filter" not in layers8["transition_0"]
    packed_apply(spec, layers_from_numpy(layers8, "cpu"), x, device="cpu")
    assert not calls


class _NoComposite:
    """A builder seen without its ``transition``: the zoo then runs a
    transition as its two layers."""

    def __init__(self, b):
        self._b = b

    def __getattr__(self, attr):
        if attr == "transition":
            raise AttributeError(attr)
        return getattr(self._b, attr)


def _records_1x1_convs(spec, composite=True):
    """Every 1x1 float conv of ``spec``'s packed bf16 forward on the CPU
    (with ``composite`` False, a transition's too, run as its two layers):
    its input, kernel and arguments, and the average pool that reads its
    output (None where another layer does)."""
    records = []

    class Recording(PackedBuilder):
        def conv_bn(self, x, filters, ksize, **kw):
            y = super().conv_bn(x, filters, ksize, **kw)
            if ksize == 1:
                records.append({"x": x, "kernel": self.layers[kw["name"]][
                    "kernel"], "y": y, "pool": None, **{
                        k: kw.get(k, d) for k, d in (
                            ("stride", 1), ("groups", 1), ("dilation", 1),
                            ("activation", None))}})
            return y

        def avg_pool(self, x, pool_size, stride=None, padding="VALID"):
            for r in records:
                if r["y"] is x:
                    r["pool"] = ((pool_size,) * 2, (stride,) * 2, padding)
            return super().avg_pool(x, pool_size, stride, padding)

    params = init_model(spec, seed=4)
    run = layers_from_numpy(prepare_runtime_arrays(
        convert_model(spec, params), spec), "cpu")
    b = Recording(run)
    with torch.inference_mode():
        spec.forward(b if composite else _NoComposite(b),
                     _images(1, spec.input_size[0]))
    return records


def _supported(r):
    return tr.transition_supported(
        r["x"], r["kernel"], (r["stride"],) * 2, r["groups"],
        (r["dilation"],) * 2, r["activation"], r["pool"])


@pytest.mark.parametrize("name, size, convs", [("quicknet", 64, 4),
                                               ("birealnet18", 64, 3),
                                               ("meliusnet22", 32, 3)])
def test_supported_says_no_to_other_models_1x1_convs(name, size, convs):
    """QuickNet's pointwise stem and transitions and Bi-RealNet-18's
    shortcuts are 1x1 convs on the bf16 stream that no average pool reads
    (QuickNet's feed binary convs; Bi-RealNet's shortcut pools before its
    conv); MeliusNet-22's transitions are grouped: the kernel takes none of
    them. DenseNet-45's three transitions, run as their two layers, are
    what it takes."""
    full = get_model(name)
    spec = zoo.ModelSpec(name, full.forward, input_size=(size, size),
                         num_classes=full.num_classes)
    records = _records_1x1_convs(spec)
    assert len(records) == convs
    for r in records:
        assert r["x"].dtype == torch.bfloat16
        assert not _supported(r), tuple(r["kernel"].shape)
    dense = _records_1x1_convs(_tiny_spec("binary_densenet45"),
                               composite=False)
    assert [r["pool"] for r in dense] == [tr.POOL] * 3
    assert all(_supported(r) for r in dense)


def test_prepare_runtime_arrays_adds_the_filter_to_transitions_only(
        densenets):
    """With the spec, the three transitions of a DenseNet get
    ``transition_filter``, the int16 bit patterns of
    ``transition_filter(kernel)``; without it, and in every other zoo
    model, no layer does."""
    spec, params, layers = densenets["binary_densenet45"]
    assert transition_layers(spec) == [f"transition_{i}" for i in range(3)]
    with_filter = sorted(k for k, v in layers.items()
                         if "transition_filter" in v)
    assert with_filter == [f"transition_{i}" for i in range(3)]
    for k in with_filter:
        bits = torch.from_numpy(layers[k]["transition_filter"])
        assert bits.dtype == torch.int16
        assert torch.equal(bits.view(torch.bfloat16), tr.transition_filter(
            torch.from_numpy(layers[k]["kernel"])))
    bare = prepare_runtime_arrays(convert_model(spec, params))
    assert not any("transition_filter" in v for v in bare.values())
    for name in ("quicknet", "birealnet18", "meliusnet22", "binary_alexnet",
                 "binary_resnet_e18"):
        assert transition_layers(get_model(name)) == []


def test_plans_of_densenet45_transitions():
    """The launch plans of the cell's three transitions at b128, as
    ``csrc/transition_conv_pool.cu`` lays out its shared memory: one block
    an SM, as many stages as fit, the farthest read the tile's last
    element."""
    plans = [tr.plan_transition(128, hw, hw, c, co)
             for hw, c, co in ((56, 448, 160), (28, 928, 256),
                               (14, 1152, 288))]
    assert [p["tiles"] for p in plans] == [3136, 784, 196]
    assert [p["chunks"] for p in plans] == [7, 15, 18]
    assert [p["stages"] for p in plans] == [6, 4, 4]
    assert [p["blocks"] for p in plans] == [132, 132, 132]
    # 1 KB to align the ring, its stages of 128 + C_out rows of 128 bytes,
    # the bias.
    assert [p["smem_bytes"] for p in plans] == [222_848, 198_656, 215_168]
    assert all(p["smem_bytes"] <= tr.MAX_SHARED_BYTES for p in plans)
    # one more stage would not fit
    assert all(p["smem_bytes"] + (128 + co) * 128 > tr.MAX_SHARED_BYTES
               for p, co in zip(plans[1:], (256, 288)))
    assert [p["out"] for p in plans] == [(128, 28, 28, 160),
                                         (128, 14, 14, 256),
                                         (128, 7, 7, 288)]
    for p in plans:
        assert tr.farthest_read(p) == p["tile_elems"] - 1 == 128 * 64 - 1
    small = tr.plan_transition(1, 2, 2, 16, 32)
    assert small["tiles"] == small["blocks"] == 1 and small["stages"] == 6
    assert tr.farthest_read(small) == 127 * 64 + 63


def test_the_plain_version_holds_the_tile_check():
    """Inside ``debug_checks()`` the plain version holds the kernel's tile
    invariant on the plan: a tile declared one element short of the
    farthest read trips it; outside, the override is refused."""
    x, kernel, bias = _inputs(1)
    farthest = tr.farthest_read(tr.plan_transition(*x.shape, 32))
    with debug_checks():
        want = tr.transition_conv_pool(x, kernel, bias)
        got = tr.transition_conv_pool(x, kernel, bias,
                                      _debug_tile_elems=farthest + 1)
        assert torch.equal(got, want)
        with pytest.raises(RuntimeError, match="transition"):
            tr.transition_conv_pool(x, kernel, bias,
                                    _debug_tile_elems=farthest)
    with pytest.raises(ValueError, match="debug_checks"):
        tr.transition_conv_pool(x, kernel, bias, _debug_tile_elems=farthest)


def test_within_tolerance():
    """One bf16 ulp, or a quarter of what the window's conv outputs may
    move; the plain chain lies within it of the exact sums."""
    x, kernel, bias = _inputs(2, hw=(8, 8), c=128, c_out=64)
    want = tr.transition_conv_pool_exact(x, kernel, bias)
    ok, ulps = tr.within_tolerance(want, want, x, kernel, bias)
    assert bool(ok.all()) and float(ulps.max()) == 0.0
    up = torch.nextafter(want.float(), torch.full_like(want.float(),
                                                      float("inf")))
    assert bool(tr.within_tolerance(up.to(torch.bfloat16), want, x, kernel,
                                    bias)[0].all())
    far = (want.float() * 1.05 + 0.5).to(torch.bfloat16)
    assert not bool(tr.within_tolerance(far, want, x, kernel, bias)[0]
                    .all())
    plain = tr.transition_conv_pool_plain(x, kernel, bias)
    assert bool(tr.within_tolerance(plain, want, x, kernel, bias)[0].all())


class _FakeLib:
    """The kernel's library as ctypes binds it, launching nothing."""

    class _Fn:
        argtypes = None
        restype = None

        def __init__(self, rc=0):
            self.calls, self.rc = [], rc

        def __call__(self, *args):
            self.calls.append(args)
            return self.rc

    def __init__(self):
        self.ce_transition_conv_pool = self._Fn()
        self.ce_error_string = self._Fn(b"invalid argument")


def test_launches_count_once_a_replay_under_a_ledger(monkeypatch):
    """A launch adds one to ``transition_conv_pool.launches`` eagerly, and
    inside ``counts.recording()`` one to the ledger, which a graph's
    replays add once each; the entry gets the plan's arguments."""
    lib = _FakeLib()
    monkeypatch.setattr(tr, "_library", lambda debug_build=False: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        _Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    x, kernel, bias = _inputs(2, hw=(8, 8), c=96, c_out=64, prefix=32)
    before = tr.transition_conv_pool.launches
    tr._launch(x, kernel, bias, None, None)
    assert tr.transition_conv_pool.launches == before + 1
    with counts.recording() as ledger:
        tr._launch(x, kernel, bias, tr.transition_filter(kernel), None)
    assert ledger == {(tr.transition_conv_pool, "launches"): 1}
    assert tr.transition_conv_pool.launches == before + 1
    counts.add(ledger, 3)
    assert tr.transition_conv_pool.launches == before + 4
    plan = tr.plan_transition(2, 8, 8, 96, 64)
    args = lib.ce_transition_conv_pool.calls[-1]
    assert args[4:] == (2, 8, 8, 96, 128, 64, plan["stages"],
                        plan["blocks"], plan["smem_bytes"], 0)
    monkeypatch.setattr(lib.ce_transition_conv_pool, "rc", 1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tr._launch(x, kernel, bias, None, None)


def test_the_sharded_forward_keeps_the_chain(densenets, monkeypatch):
    """``ShardedBuilder`` runs a transition as ``conv_bn``, which it may
    shard over the model axis, and the pool: the kernel's wrapper is never
    called, and the output equals ``packed_apply``'s, whose transitions
    take the wrapper (its plain version here)."""
    from compute_engine_tpu_torch.parallel.mesh import make_mesh
    from compute_engine_tpu_torch.parallel.partition import sharded_apply
    from compute_engine_tpu_torch.parallel.sharding import shard_artifact

    assert ShardedBuilder.transition is _Base.transition
    spec, _, layers = densenets["binary_densenet28"]
    x = _images(2).numpy()
    want = packed_apply(spec, layers, x, device="cpu")
    calls = []
    monkeypatch.setattr(tr, "transition_conv_pool",
                        lambda *a, **kw: calls.append(1))
    mesh = make_mesh((1, 2), devices=["cpu"] * 2)
    got = sharded_apply(spec, shard_artifact(layers, mesh), x, mesh)
    assert not calls
    assert torch.equal(got, want)
