"""The "mxu" and "s2d" lowerings of the port (``kernels/bconv2d.py``, plain
versions on the CPU) against the JAX functions of the same name, their error
paths, TF32 scoping of the float32 entry points, and the benchmark's memory
metrics against JAX's.

Tolerances: integer and bitpacked outputs equal; float outputs within one
FMA rounding of the epilogue (rtol 2e-5, atol 2e-4, ``kernels/residual.py``):
JAX's compiler may contract the multiply-add, the port never does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core import (
    Activation as JActivation,
    BConv2DParams as JParams,
    Padding as JPadding,
    bitpack as jbitpack,
)
from compute_engine_tpu.kernels.bconv2d import (
    bconv2d_mxu as jbconv2d_mxu,
    bconv2d_mxu_s2d as jbconv2d_mxu_s2d,
)
from compute_engine_tpu.kernels.select import (select_bconv2d_kernel as
                                               jselect)

from compute_engine_tpu_torch.core import (Activation, BConv2DParams,
                                           OutputTransform, Padding,
                                           bitpack_np,
                                           compute_output_thresholds,
                                           fuse_output_transform)
from compute_engine_tpu_torch.core.reference import bconv2d_reference
from compute_engine_tpu_torch.kernels.bconv2d import (bconv2d_mxu,
                                                      bconv2d_mxu_float_in,
                                                      bconv2d_mxu_s2d,
                                                      bdense_mxu,
                                                      bdense_mxu_float_in)
from compute_engine_tpu_torch.kernels.select import select_bconv2d_kernel
from compute_engine_tpu_torch.ops import bconv2d

FLOAT_TOL = dict(rtol=2e-5, atol=2e-4)

# tests/test_fast_kernels.py's cases: (in_shape, filter (O, FH, FW), stride,
# dilation, padding, pad_value, groups, activation).
CASES = [
    ((1, 8, 8, 32), (16, 3, 3), (1, 1), (1, 1), "VALID", 1, 1, "NONE"),
    ((2, 7, 9, 64), (8, 3, 3), (1, 1), (1, 1), "SAME", 1, 1, "NONE"),
    ((1, 8, 8, 64), (32, 3, 3), (2, 2), (1, 1), "SAME", 1, 1, "RELU"),
    ((1, 10, 10, 33), (7, 2, 2), (1, 1), (2, 2), "VALID", 1, 1, "NONE"),
    ((1, 8, 8, 64), (16, 3, 3), (1, 1), (1, 1), "SAME", 0, 1, "NONE"),
    ((1, 6, 6, 128), (16, 3, 3), (1, 1), (1, 1), "SAME", 1, 4, "RELU6"),
    ((1, 4, 4, 300), (40, 2, 2), (1, 1), (1, 1), "SAME", 1, 1,
     "RELU_N1_TO_1"),
]
# The cases the space-to-depth retile takes (groups 1, undilated, even C).
S2D_CASES = [c for c in CASES
             if c[6] == 1 and c[3] == (1, 1) and c[0][-1] % 2 == 0]


def _params(case):
    in_shape, _, stride, dilation, padding, pad_value, groups, act = case
    kw = dict(channels_in=in_shape[-1], stride=stride, dilation=dilation,
              pad_value=pad_value, groups=groups)
    return (BConv2DParams(padding=Padding[padding],
                          activation=Activation[act], **kw),
            JParams(padding=JPadding[padding], activation=JActivation[act],
                    **kw))


def _transforms(rng, case, output_kind, params):
    in_shape, (o, fh, fw) = case[0], case[1]
    post_mul = (rng.uniform(0.1, 2.0, o)
                * rng.choice([-1.0, 1.0], o)).astype(np.float32)
    post_bias = rng.uniform(-5.0, 5.0, o).astype(np.float32)
    k = params.backtransform_add(fh, fw)
    if output_kind == "bitpacked":
        return OutputTransform(thresholds=compute_output_thresholds(
            post_mul, post_bias, k, params.activation))
    scale, zp = (0.15, 3) if output_kind == "int8" else (None, 0)
    return fuse_output_transform(post_mul, post_bias, k, params.activation,
                                 output_scale=scale, output_zero_point=zp)


def _assert_same(got, want, output_kind):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if output_kind == "bitpacked":
        want = want.view(np.int32)
    assert got.shape == want.shape
    if output_kind == "float":
        np.testing.assert_allclose(got, want, **FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


def _case(rng, case):
    in_shape, (o, fh, fw) = case[0], case[1]
    groups = case[6]
    x = rng.choice(np.array([-1.0, 1.0], np.float32), size=in_shape)
    w = rng.choice(np.array([-1.0, 1.0], np.float32),
                   size=(o, fh, fw, in_shape[-1] // groups))
    return x, w


def _t(words):
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


@pytest.mark.parametrize("output_kind", ["float", "int8", "bitpacked"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_bconv2d_mxu_matches_jax(rng, case, output_kind):
    params, jparams = _params(case)
    x, w = _case(rng, case)
    tr = _transforms(rng, case, output_kind, params)
    xp, wp = bitpack_np(x), bitpack_np(w)
    want = jbconv2d_mxu(jnp.asarray(xp), jnp.asarray(wp), tr, jparams,
                        output_kind)
    got = bconv2d_mxu(_t(xp), _t(wp), tr, params, output_kind)
    _assert_same(got, want, output_kind)
    # The op's "mxu" kernel, against the port's packed oracle.
    ref = bconv2d_reference(_t(xp), _t(wp), tr, params, output_kind)
    op = bconv2d(_t(xp), _t(wp), tr, params, output_kind, kernel="mxu")
    if output_kind == "float":
        torch.testing.assert_close(op, ref, **FLOAT_TOL)
    else:
        assert torch.equal(op, ref)


@pytest.mark.parametrize("output_kind", ["float", "int8", "bitpacked"])
@pytest.mark.parametrize("case", S2D_CASES, ids=range(len(S2D_CASES)))
def test_bconv2d_mxu_s2d_matches_jax(rng, case, output_kind):
    """Float activations (with +0.0 and -0.0, both +1) in."""
    params, jparams = _params(case)
    _, w = _case(rng, case)
    x = rng.normal(0, 1, case[0]).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[3::11] = -0.0
    tr = _transforms(rng, case, output_kind, params)
    wp = bitpack_np(w)
    want = jbconv2d_mxu_s2d(jnp.asarray(x), jnp.asarray(wp), tr, jparams,
                            output_kind)
    got = bconv2d_mxu_s2d(torch.from_numpy(x), _t(wp), tr, params,
                          output_kind)
    _assert_same(got, want, output_kind)
    # ... and equals the direct lowering on the same float input.
    direct = bconv2d_mxu_float_in(torch.from_numpy(x), _t(wp), tr, params,
                                  output_kind)
    _assert_same(got, direct.numpy(), output_kind)


def test_unpacked_filter_is_used_as_given(rng):
    case = CASES[1]
    params, _ = _params(case)
    x, w = _case(rng, case)
    tr = _transforms(rng, case, "float", params)
    upf = torch.from_numpy(w.transpose(1, 2, 3, 0).astype(np.int8))
    want = bconv2d_mxu(_t(bitpack_np(x)), _t(bitpack_np(w)), tr, params)
    got = bconv2d_mxu(_t(bitpack_np(x)), _t(bitpack_np(w)), tr, params,
                      unpacked_filter=upf)
    assert torch.equal(got, want)
    got = bconv2d_mxu_s2d(torch.from_numpy(x), _t(bitpack_np(w)), tr, params,
                          unpacked_filter=upf)
    torch.testing.assert_close(got, want, **FLOAT_TOL)


@pytest.mark.parametrize("output_kind", ["float", "bitpacked"])
def test_bdense_mxu_equals_the_gemm(rng, output_kind):
    """Both binary-dense "mxu" lowerings equal the binary GEMM's output."""
    from compute_engine_tpu_torch.kernels.bgemm import bgemm
    from compute_engine_tpu_torch.ops import quantize

    c, units = 200, 70
    x = torch.from_numpy(rng.normal(0, 1, (5, c)).astype(np.float32))
    w = rng.choice([-1.0, 1.0], size=(units, c)).astype(np.float32)
    post_mul = rng.uniform(-2, 2, units).astype(np.float32)
    post_bias = rng.uniform(-5, 5, units).astype(np.float32)
    wp = _t(bitpack_np(w))
    k_pm1 = torch.from_numpy(w.T.astype(np.int8).copy())
    if output_kind == "bitpacked":
        thr = compute_output_thresholds(post_mul, post_bias, c)
        tr = OutputTransform(thresholds=thr)
        want = bgemm(quantize(x), wp.t(), thresholds=thr,
                     out_kind="bitpacked")
    else:
        tr = fuse_output_transform(post_mul, post_bias, c)
        want = bgemm(quantize(x), wp.t(), tr.multiplier, tr.bias,
                     clamp_min=tr.clamp_min, clamp_max=tr.clamp_max)
    for got in (bdense_mxu_float_in(x, k_pm1, tr, output_kind),
                bdense_mxu(quantize(x), k_pm1, tr, output_kind)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_s2d_stride2_valid_unconsumed_rows(rng):
    """A stride-2 VALID conv whose input has trailing rows no output reads:
    the retile crops them (exact) instead of padding by a negative amount,
    and matches the direct lowering and JAX's retile."""
    for (h, fh) in ((9, 2), (11, 4)):
        c_in, c_out = 16, 32
        x = rng.normal(0, 1, (2, h, h, c_in)).astype(np.float32)
        wp = bitpack_np(rng.choice([-1.0, 1.0], (c_out, fh, fh, c_in))
                        .astype(np.float32))
        params = BConv2DParams(channels_in=c_in, stride=(2, 2),
                               padding=Padding.VALID)
        jparams = JParams(channels_in=c_in, stride=(2, 2),
                          padding=JPadding.VALID)
        tr = fuse_output_transform(np.ones(c_out, np.float32),
                                   np.zeros(c_out, np.float32),
                                   fh * fh * c_in)
        want = bconv2d_mxu_float_in(torch.from_numpy(x), _t(wp), tr, params)
        got = bconv2d_mxu_s2d(torch.from_numpy(x), _t(wp), tr, params)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        jwant = jbconv2d_mxu_s2d(jnp.asarray(x), jnp.asarray(wp), tr,
                                 jparams)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-5)


def test_s2d_rejects_unsupported_configs(rng):
    c_in, c_out = 64, 16
    xf = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, c_in)).astype(
        np.float32))
    w = _t(bitpack_np(rng.choice([-1.0, 1.0], size=(c_out, 3, 3, c_in))
                      .astype(np.float32)))
    t = fuse_output_transform(np.ones(c_out, np.float32),
                              np.zeros(c_out, np.float32), 9 * c_in)
    for bad in (
        BConv2DParams(channels_in=c_in, stride=(3, 3), padding=Padding.SAME),
        BConv2DParams(channels_in=c_in, stride=(1, 2), padding=Padding.SAME),
        BConv2DParams(channels_in=c_in, dilation=(2, 2),
                      padding=Padding.SAME),
    ):
        with pytest.raises(ValueError, match="s2d path requires"):
            bconv2d_mxu_s2d(xf, w, t, bad)
    with pytest.raises(ValueError, match="channels_in"):
        bconv2d_mxu_s2d(
            xf, w, t, BConv2DParams(channels_in=128, padding=Padding.SAME))


def test_selector_falls_back_when_s2d_invalid():
    """The selector never returns "s2d" where the retile cannot run, in
    either package, whatever the table says."""
    from compute_engine_tpu_torch.kernels import select

    key = select._key("float", 64, 64, 9, 128 * 56 * 56, "float")
    # An entry decides only layers of the geometry it was measured at: the
    # table says "s2d" at each geometry asked below.
    select.kernel_table()[key] = {"s1/one": "s2d", "s1/one/g2": "s2d",
                                  "s3/one": "s2d"}
    try:
        for sel in (select_bconv2d_kernel, jselect):
            assert sel("float", c_in=64, c_out=64, fh=3, fw=3,
                       m=128 * 56 * 56, groups=2) == "mxu"
            assert sel("float", c_in=64, c_out=64, fh=3, fw=3,
                       m=128 * 56 * 56, stride=(3, 3)) == "mxu"
            assert sel("float", c_in=33, c_out=64, fh=3, fw=3,
                       m=128 * 56 * 56) != "s2d"
        assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                     m=128 * 56 * 56) == "s2d"
    finally:
        select.reset_table()


# -- TF32 scoping of the float32 entry points -------------------------------


def _flag_recorder(monkeypatch):
    """Record (cudnn, matmul) TF32 flags at every float conv of a forward."""
    from compute_engine_tpu_torch.models import layers as L

    seen = []
    conv2d = L.conv2d

    def recording(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*a, **kw)

    monkeypatch.setattr(L, "conv2d", recording)
    return seen


@pytest.fixture
def tf32_on():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = before


def test_float32_entry_points_turn_tf32_off(monkeypatch, tf32_on):
    """Inside a float32 packed_apply, calibrate_model, float_apply,
    train_briefly and recalibrate_bn_stats both TF32 flags are off; after
    each the caller's flags are back."""
    from compute_engine_tpu_torch.models import (calibrate_model,
                                                 convert_model, float_apply,
                                                 init_model, packed_apply,
                                                 tiny_quicknet, train_briefly)
    from compute_engine_tpu_torch.models.train import recalibrate_bn_stats

    spec = tiny_quicknet(num_classes=4)
    params = init_model(spec, seed=0, randomize_bn=True)
    layers = convert_model(spec, params)
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    seen = _flag_recorder(monkeypatch)
    for run in (
            lambda: packed_apply(spec, layers, x,
                                 compute_dtype=torch.float32, device="cpu"),
            lambda: calibrate_model(spec, params, [x], device="cpu"),
            lambda: float_apply(spec, params, x, device="cpu"),
            lambda: train_briefly(spec, params, steps=1, batch=2,
                                  device="cpu"),
            lambda: recalibrate_bn_stats(spec, params, [x], device="cpu")):
        seen.clear()
        run()
        assert seen and set(seen) == {(False, False)}, seen
        # ... and the caller's flags are back after the call.
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    # A bf16 forward leaves them as the caller set them.
    seen.clear()
    packed_apply(spec, layers, x, device="cpu")
    assert seen and set(seen) == {(True, True)}


def test_tf32_flags_restored_after_an_error(tf32_on):
    from compute_engine_tpu_torch.device import exact_float32

    with pytest.raises(KeyError):
        with exact_float32():
            assert not torch.backends.cudnn.allow_tf32
            raise KeyError("inside")
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


# -- the benchmark's memory metrics -------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_memory_metrics_match_jax(tmp_path, int8):
    """``weights_mb`` and ``input_mb`` of the same artifact, loaded by each
    package, from the arrays each runtime holds."""
    from compute_engine_tpu.converter import (load_artifact as jload,
                                              split_arrays)
    from compute_engine_tpu.models import (prepare_runtime_arrays as
                                           jprepare)
    from compute_engine_tpu.runtime.benchmark import _memory_metrics

    from compute_engine_tpu_torch.converter import (load_artifact,
                                                    save_artifact)
    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.models import (calibrate_model,
                                                 convert_model, init_model,
                                                 prepare_runtime_arrays,
                                                 tiny_quicknet)
    from compute_engine_tpu_torch.runtime.benchmark import memory_metrics

    spec = tiny_quicknet(num_classes=10)
    params = init_model(spec, seed=1, randomize_bn=True)
    ranges = {}
    if int8:
        x = np.random.default_rng(2).normal(0, 1, (4, 32, 32, 3)).astype(
            np.float32)
        in_r, out_r = calibrate_model(spec, params, [x], with_outputs=True,
                                      device="cpu")
        ranges = dict(int8_ranges=in_r, int8_out_ranges=out_r)
    path = str(tmp_path / "m.npz")
    save_artifact(path, convert_model(spec, params, **ranges), spec.name)
    x = np.zeros((3, 32, 32, 3), np.float32)
    _, arrays = split_arrays(jprepare(jload(path)[2]))
    want = _memory_metrics(arrays, jnp.asarray(x))
    runtime = layers_from_numpy(prepare_runtime_arrays(load_artifact(path)[2]))
    got = memory_metrics(runtime, torch.from_numpy(x))
    assert got == {k: want[k] for k in ("weights_mb", "input_mb")}
    assert got["weights_mb"] > 0
