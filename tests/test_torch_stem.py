"""The float stem and its max pool in one kernel (``kernels/stem.py``), on
the CPU: the plain version is the packed builder's chain bit for bit, the
wrapper refuses what the kernel does not take, the launch plan and the
filter's layout are the kernel's, the builder routes Bi-RealNet-18's and
the BinaryDenseNets' stem to it and nothing else, with logits equal to the
chain's, and a deferred stem conv is realised once. The kernel itself runs
on the card only (``tests/test_torch_stem_card.py``, ``chip_smoke.py
--stem-only``).
"""

import importlib

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.interop import layers_from_numpy
from compute_engine_tpu_torch.kernels import debug_checks
from compute_engine_tpu_torch.kernels import stem
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply,
                                             prepare_runtime_arrays)
from compute_engine_tpu_torch.models import builder as builder_mod
from compute_engine_tpu_torch.models import layers as L

SEED = 2147623001


def _stem_inputs(batch, shape=(224, 224, 3), ksize=(7, 7), c_out=64,
                 dtype=torch.float32, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, *shape)).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    x.reshape(-1)[1::89] = -0.0
    kernel = rng.normal(0, 0.15, (*ksize, shape[-1], c_out))
    bias = rng.normal(0, 1, c_out)
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(kernel.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


def _chain(x, kernel, bias, activation=None):
    """The packed builder's float conv, then its max pool, as it ran the
    stem before the kernel (``PackedBuilder.conv_bn``, ``_Base.max_pool``)."""
    y = L.conv2d(x.to(torch.bfloat16), kernel, (2, 2), "SAME")
    y = L.apply_activation(y + bias, activation).to(torch.bfloat16)
    return L.max_pool(y, (3, 3), (2, 2), "SAME")


@pytest.mark.parametrize("batch, activation", [(1, None), (2, None),
                                               (3, "relu"), (2, "relu6")])
def test_plain_version_is_the_chain(batch, activation):
    x, kernel, bias = _stem_inputs(batch)
    want = _chain(x, kernel, bias, activation)
    assert want.shape == (batch, 56, 56, 64) and want.dtype == torch.bfloat16
    for got in (stem.stem_conv_pool_plain(x, kernel, bias,
                                          activation=activation),
                stem.stem_conv_pool(x, kernel, bias, activation=activation)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case, error", [
    ("five channels", ValueError), ("K over 160", ValueError),
    ("32 output channels", ValueError), ("not contiguous", ValueError),
    ("float16", TypeError), ("uint8", TypeError), ("stride 1", ValueError),
    ("sigmoid", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    x, kernel, bias = _stem_inputs(1, shape=(16, 16, 3))
    stride, activation = (2, 2), None
    if case == "five channels":
        x, kernel, bias = _stem_inputs(1, shape=(16, 16, 5), ksize=(3, 3))
    elif case == "K over 160":  # BinaryAlexNet's 11x11 stem: K = 11 * 34
        x, kernel, bias = _stem_inputs(1, shape=(16, 16, 3), ksize=(11, 11))
    elif case == "32 output channels":
        x, kernel, bias = _stem_inputs(1, shape=(16, 16, 3), c_out=32)
    elif case == "not contiguous":
        x = x.permute(0, 2, 1, 3)
    elif case == "float16":
        x = x.to(torch.float16)
    elif case == "uint8":
        x = x.to(torch.uint8)
    elif case == "stride 1":
        stride = (1, 1)
    else:
        activation = "sigmoid"
    with pytest.raises(error):
        stem.stem_conv_pool(x, kernel, bias, stride, activation)


def test_k_counts_each_filter_row_padded_to_even():
    assert stem.stem_k(7, 7, 3) == 7 * 22 == 154
    assert stem.stem_k(7, 7, 4) == 196 > stem.MAX_K
    assert stem.stem_k(5, 5, 1) == 30 and stem.stem_k(3, 3, 4) == 36
    assert stem.stem_k(11, 11, 3) == 11 * 34


def test_plan_of_the_b128_stem():
    """The launch plan of the cells' stem, as ``csrc/stem_conv_pool.cu``
    lays out its shared memory: two blocks an SM fit, and the farthest read
    lies inside the patch, for every filter the kernel takes."""
    plan = stem.plan_stem(128, 224, 224, 3, 7, 7, itemsize=4)
    assert plan["pad"] == (2, 2) and plan["pool_pad"] == (0, 0)
    assert plan["conv_out"] == (112, 112) and plan["out"] == (56, 56)
    assert plan["tiles"] == 128 * 8 * 7 and plan["blocks"] == 2 * 132
    assert plan["patch"] == (35, 120)
    assert plan["smem_bytes"] == 110_784
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    assert stem.plan_stem(128, 224, 224, 3, 7, 7, itemsize=2)[
        "smem_bytes"] == 93_984
    # Odd sizes take the other SAME paddings; a small batch, fewer blocks.
    odd = stem.plan_stem(1, 225, 33, 3, 7, 7)
    assert odd["pad"] == (3, 3) and odd["pool_pad"] == (1, 1)
    assert odd["out"] == (57, 9) and odd["blocks"] == odd["tiles"] == 9 * 2
    for kh, kw, c in ((7, 7, 3), (5, 5, 1), (3, 3, 4), (7, 5, 2), (1, 1, 4),
                      (9, 9, 1)):
        if stem.stem_k(kh, kw, c) > stem.MAX_K:
            continue
        plan = stem.plan_stem(2, 64, 64, c, kh, kw)
        rows, row_stride = plan["patch"]
        assert stem.farthest_read(plan, kh, kw, c) < rows * row_stride
        assert plan["smem_bytes"] <= stem.MAX_SHARED_BYTES


def test_filter_layout():
    """Row o of the (64, 160) filter holds k = ky * KR + kx * C + c of the
    bf16-rounded kernel, zeros in each row's pad slot and past K."""
    _, kernel, _ = _stem_inputs(1, shape=(8, 8, 3))
    f = stem.stem_filter(kernel)
    assert f.shape == (64, 160) and f.dtype == torch.bfloat16
    kb = kernel.to(torch.bfloat16)
    for ky in range(7):
        for kx in range(7):
            for c in range(3):
                assert torch.equal(f[:, ky * 22 + kx * 3 + c], kb[ky, kx, c])
        assert not f[:, ky * 22 + 21].any()  # the pad slot
    assert not f[:, 154:].any()


def test_the_plain_version_holds_the_patch_check():
    """Inside ``debug_checks()`` the plain version holds the kernel's patch
    invariant on the plan: a patch declared one element short of the
    farthest read trips it; outside, the override is refused."""
    x, kernel, bias = _stem_inputs(1, shape=(32, 32, 3))
    farthest = stem.farthest_read(stem.plan_stem(*x.shape, 7, 7), 7, 7, 3)
    with debug_checks():
        want = stem.stem_conv_pool(x, kernel, bias)
        got = stem.stem_conv_pool(x, kernel, bias,
                                  _debug_patch_elems=farthest + 1)
        assert torch.equal(got, want)
        with pytest.raises(RuntimeError, match="stem"):
            stem.stem_conv_pool(x, kernel, bias, _debug_patch_elems=farthest)
    with pytest.raises(ValueError, match="debug_checks"):
        stem.stem_conv_pool(x, kernel, bias, _debug_patch_elems=farthest)


def test_within_tolerance():
    """One bf16 ulp, or the float32 reordering bound near zero."""
    x, kernel, bias = _stem_inputs(1, shape=(32, 32, 3))
    want = stem.stem_conv_pool_exact(x, kernel, bias)
    ok, ulps = stem.within_tolerance(want, want, x, kernel, bias)
    assert bool(ok.all()) and float(ulps.max()) == 0.0
    up = torch.nextafter(want.float(), torch.full_like(want.float(),
                                                      float("inf")))
    one = up.to(torch.bfloat16)  # a float32 step up rounds back: 0 ulps
    assert bool(stem.within_tolerance(one, want, x, kernel, bias)[0].all())
    far = (want.float() * 1.05 + 0.5).to(torch.bfloat16)
    assert not bool(stem.within_tolerance(far, want, x, kernel, bias)[0]
                    .all())
    # The plain chain lies within it of the exact sums.
    plain = stem.stem_conv_pool_plain(x, kernel, bias)
    assert bool(stem.within_tolerance(plain, want, x, kernel, bias)[0].all())


def _tiny(name):
    return importlib.import_module(f"portbench.tiny.{name}").tiny({})[1]


@pytest.fixture(scope="module")
def tiny_models():
    """The CPU-sized models of the benchmark's configurations
    (``portbench/tiny/``) with runtime layers and a batch of 2 images."""
    out = {}
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    for name in ("birealnet18", "binary_densenet45", "quicknet"):
        spec = _tiny(name)
        layers = prepare_runtime_arrays(convert_model(
            spec, init_model(spec, seed=0, randomize_bn=True)))
        out[name] = (spec, layers, x)
    return out


@pytest.mark.parametrize("name, calls", [("birealnet18", 1),
                                         ("binary_densenet45", 1),
                                         ("quicknet", 0)])
def test_the_builder_routes_the_stem_to_the_kernel(tiny_models, name, calls,
                                                   monkeypatch):
    """Bi-RealNet-18's and DenseNet-45's 7x7 stem and its max pool go to
    the stem's wrapper once a forward, QuickNet's 3x3 stem (16 channels,
    read by a depthwise conv) never; the logits equal, bit for bit, those
    of the same forward with the routing off (the chain)."""
    spec, layers, x = tiny_models[name]
    run = layers_from_numpy(layers, "cpu")
    seen = []
    kernel_fn = stem.stem_conv_pool

    def recording(*a, **kw):
        seen.append(kw.get("filter_bf16"))
        return kernel_fn(*a, **kw)

    monkeypatch.setattr(stem, "stem_conv_pool", recording)
    got = packed_apply(spec, run, x, return_logits=True, device="cpu")
    assert len(seen) == calls
    if calls:  # the filter prepared at load is the one passed
        assert torch.equal(seen[0], stem.stem_filter(
            run["stem_conv"]["kernel"]))
    monkeypatch.setattr(stem, "stem_supported", lambda *a, **kw: False)
    want = packed_apply(spec, run, x, return_logits=True, device="cpu")
    assert len(seen) == calls
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["birealnet18", "binary_densenet45",
                                  "quicknet"])
def test_prepare_runtime_arrays_adds_the_stem_filter(tiny_models, name):
    """Only a conv the kernel may take gets ``stem_filter``: the stem's
    filter as int16 bit patterns of its bf16 values."""
    _, layers, _ = tiny_models[name]
    with_filter = sorted(k for k, v in layers.items() if "stem_filter" in v)
    assert with_filter == ([] if name == "quicknet" else ["stem_conv"])
    for k in with_filter:
        bits = torch.from_numpy(layers[k]["stem_filter"])
        assert bits.dtype == torch.int16
        assert torch.equal(bits.view(torch.bfloat16), stem.stem_filter(
            torch.from_numpy(layers[k]["kernel"])))


def _stem_builder(compute_dtype=torch.bfloat16):
    _, kernel, bias = _stem_inputs(1, shape=(16, 16, 3))
    layer = {"kind": "conv", "kernel": kernel, "bias": bias,
             "stride": (2, 2), "padding": "SAME", "activation": None,
             "groups": 1, "dilation": (1, 1)}
    return builder_mod.PackedBuilder({"stem_conv": layer},
                                     compute_dtype=compute_dtype)


def test_a_deferred_stem_conv_consumed_twice_runs_once(monkeypatch):
    """Two consumers other than the pool realise the conv once, by the
    chain; two pools of it run the wrapper once; a float32 stream takes
    the chain at once."""
    x = _stem_inputs(2, shape=(16, 16, 3))[0]
    convs, pools = [], []
    conv2d, kernel_fn = L.conv2d, stem.stem_conv_pool
    monkeypatch.setattr(L, "conv2d",
                        lambda *a, **kw: convs.append(1) or conv2d(*a, **kw))
    monkeypatch.setattr(stem, "stem_conv_pool",
                        lambda *a, **kw: pools.append(1) or kernel_fn(*a,
                                                                      **kw))
    b = _stem_builder()
    y = b.conv_bn(x, 64, 7, stride=2, name="stem_conv")
    assert isinstance(y, builder_mod._DeferredStem) and not convs
    first = b.activation(y, "relu")
    second = b.add(y, y)
    assert len(convs) == 1 and not pools
    assert torch.equal(first, torch.relu(y.to_float()))
    assert torch.equal(second, y.to_float() + y.to_float())
    p1, p2 = b.max_pool(y, 3, 2), b.max_pool(y, 3, 2)
    # one wrapper call, whose plain version (on the CPU) runs its own conv
    assert p1 is p2 and len(pools) == 1 and len(convs) == 2
    # A pool the kernel does not take reads the conv through the chain.
    valid = b.max_pool(y, 3, 2, padding="VALID")
    assert torch.equal(valid, L.max_pool(y.to_float(), (3, 3), (2, 2),
                                         "VALID"))
    assert len(pools) == 1
    b32 = _stem_builder(torch.float32)
    y32 = b32.conv_bn(x, 64, 7, stride=2, name="stem_conv")
    assert isinstance(y32, torch.Tensor) and y32.dtype == torch.float32
