"""The accuracy protocol of ``compute_engine_tpu_torch.scripts.
accuracy_fixtures`` against the JAX package: a tiny QuickNet trained by the
JAX package, its parameters and artifacts carried across, then the port's
``record`` on the CPU beside the same forwards (the float oracle, the
packed float32, bfloat16, true-int8 and packed-domain paths) computed by the
JAX package on the same inputs, as the JAX repo's
``scripts/make_accuracy_fixtures.py`` computes them, and the oracle with
bfloat16 operands in its float convs and dense layers, which the record
holds the bfloat16, int8 and packed-domain paths against.

Stated tolerances: agreement counts and the oracle's top-1 equal; the
oracle's first logits within 1e-4; the dprob quantiles within 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compute_engine_tpu.models import FloatBuilder as JFloatBuilder
from compute_engine_tpu.models import ModelSpec as JModelSpec
from compute_engine_tpu.models import (calibrate_model as jcalibrate,
                                       convert_model as jconvert,
                                       float_apply as jfloat_apply,
                                       init_model as jinit,
                                       packed_apply as jpacked_apply,
                                       tiny_quicknet as jtiny_quicknet,
                                       train_briefly as jtrain_briefly)
from compute_engine_tpu.models.train import (
    clustered_batch as jclustered_batch,
    make_prototypes as jmake_prototypes,
    recalibrate_bn_stats as jrecalibrate)

from compute_engine_tpu_torch.interop import params_from_numpy
from compute_engine_tpu_torch.models import (ModelSpec, convert_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.scripts import accuracy_fixtures as af

KW = dict(section_filters=(32, 64), section_blocks=(1, 1), num_classes=8,
          input_size=32)
SPEC, JSPEC = tiny_quicknet(**KW), jtiny_quicknet(**KW)
SEED = 0


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _JOracleBf16Operands(JFloatBuilder):
    """JAX's oracle with the operands of its float convs and dense layers
    in bfloat16 and float32 sums: what XLA's default precision computes for
    a float32 conv or matmul on a TPU."""

    def conv_bn(self, x, *a, **kw):
        return super().conv_bn(x.astype(jnp.bfloat16), *a, **kw)

    def depthwise_conv_bn(self, x, *a, **kw):
        return super().depthwise_conv_bn(x.astype(jnp.bfloat16), *a, **kw)

    def dense(self, x, *a, **kw):
        return super().dense(x.astype(jnp.bfloat16), *a, **kw)


def _quantiles(d):
    return {"dprob_p50": float(np.percentile(d, 50)),
            "dprob_p99": float(np.percentile(d, 99)),
            "dprob_max": float(np.max(d))}


def _jax_record(trained, protos, layers, layers8, seed):
    """The evaluation loop of scripts/make_accuracy_fixtures.py::run_model,
    through the JAX package, with each path also held against the oracle at
    its own operand precision, as ``accuracy_fixtures.record`` holds it."""
    rng = np.random.default_rng(2000 + seed)
    agree, dprob, agree_exact, dprob_exact = {}, {}, {}, {}
    oracle_acc, oracle_bf16_acc, first, n = 0, 0, None, 0
    for _ in range(af.N_EVAL // af.BATCH):
        x, y = jclustered_batch(protos, rng, af.BATCH, spread=af.EVAL_SPREAD)
        xj = jnp.asarray(x)
        want = {"float32": np.asarray(jfloat_apply(JSPEC, trained, xj)),
                "bfloat16": np.asarray(JSPEC.forward(
                    _JOracleBf16Operands(trained), xj))}
        if first is None:
            first = want["float32"][:4, :16]
        top = {dt: w.argmax(-1) for dt, w in want.items()}
        oracle_acc += int((top["float32"] == y).sum())
        oracle_bf16_acc += int((top["bfloat16"] == y).sum())
        for key, fn in {
            "packed_f32": lambda: jpacked_apply(
                JSPEC, layers, xj, compute_dtype=jnp.float32),
            "packed_bf16": lambda: jpacked_apply(
                JSPEC, layers, xj, compute_dtype=jnp.bfloat16),
            "packed_int8": lambda: jpacked_apply(
                JSPEC, layers8, xj, compute_dtype=jnp.bfloat16),
            "packed_domain": lambda: jpacked_apply(
                JSPEC, layers, xj, compute_dtype=jnp.bfloat16,
                domain="packed"),
        }.items():
            probs = np.asarray(fn(), np.float32)
            dt = af.ORACLE_OPERANDS[key]
            agree[key] = agree.get(key, 0) + int(
                (probs.argmax(-1) == top[dt]).sum())
            dprob.setdefault(key, []).extend(
                np.abs(probs - want[dt]).max(axis=-1).tolist())
            agree_exact[key] = agree_exact.get(key, 0) + int(
                (probs.argmax(-1) == top["float32"]).sum())
            dprob_exact.setdefault(key, []).extend(
                np.abs(probs - want["float32"]).max(axis=-1).tolist())
        n += af.BATCH
    return {
        "images": n,
        "paths": {k: {"top1_agreement": v / n, **_quantiles(dprob[k]),
                      "oracle_operands": af.ORACLE_OPERANDS[k],
                      "exact_oracle": {
                          "top1_agreement": agree_exact[k] / n,
                          "dprob_p99": _quantiles(dprob_exact[k])[
                              "dprob_p99"]}}
                  for k, v in agree.items()},
        "oracle": {"top1_accuracy": oracle_acc / n,
                   "bf16_operands_top1_accuracy": oracle_bf16_acc / n,
                   "first_logits_4x16": np.asarray(first, np.float64)},
        "train_loss": None,
    }


@pytest.fixture(scope="module")
def records():
    """JAX trains (the protocol's seeds, 60 steps of 64 at this size),
    re-estimates BN and converts; both packages then record."""
    protos = jmake_prototypes(1000 + SEED, JSPEC.input_size, 8)
    trained, info = jtrain_briefly(JSPEC, jinit(JSPEC, seed=SEED), steps=60,
                                   batch=64, seed=SEED, protos=protos)
    recal_rng = np.random.default_rng(4000 + SEED)
    trained = _numpy(jrecalibrate(
        JSPEC, trained,
        [jclustered_batch(protos, recal_rng, af.BATCH,
                          spread=af.EVAL_SPREAD)[0]
         for _ in range(af.RECAL_BATCHES)]))
    layers = jconvert(JSPEC, trained)
    in_r, out_r = jcalibrate(
        JSPEC, trained,
        [jclustered_batch(protos, np.random.default_rng(3000 + SEED),
                          af.TRAIN_BATCH)[0]], with_outputs=True)
    layers8 = jconvert(JSPEC, trained, int8_ranges=in_r,
                       int8_out_ranges=out_r)
    want = _jax_record(trained, protos, layers, layers8, SEED)
    got = af.record(SPEC, params_from_numpy(trained), protos, layers,
                    layers8, seed=SEED, device="cpu", train_loss=info)
    return got, want, info


def test_record_keys_are_the_jax_scripts(records):
    got, want, info = records
    assert set(got) == set(want) == {"images", "paths", "oracle",
                                     "train_loss"}
    assert set(got["paths"]) == set(want["paths"]) == set(af.PATHS)
    # The JAX script's keys, and beside them the oracle each path is held
    # against and its reading against the float32 oracle.
    script_path_keys = {"top1_agreement", "dprob_p50", "dprob_p99",
                        "dprob_max"}
    for k in af.PATHS:
        assert set(got["paths"][k]) == set(want["paths"][k]) == (
            script_path_keys | {"oracle_operands", "exact_oracle"})
        assert set(got["paths"][k]["exact_oracle"]) == {"top1_agreement",
                                                        "dprob_p99"}
    assert set(got["oracle"]) == set(want["oracle"]) == {
        "top1_accuracy", "first_logits_4x16", "bf16_operands_top1_accuracy"}
    assert got["train_loss"] == info
    assert got["images"] == want["images"] == af.N_EVAL


def test_record_agrees_with_jax(records):
    got, want, _ = records
    assert got["oracle"]["top1_accuracy"] == want["oracle"]["top1_accuracy"]
    assert got["oracle"]["top1_accuracy"] >= af.ORACLE_MIN
    np.testing.assert_allclose(got["oracle"]["first_logits_4x16"],
                               want["oracle"]["first_logits_4x16"],
                               rtol=0, atol=1e-4)
    assert (got["oracle"]["bf16_operands_top1_accuracy"]
            == want["oracle"]["bf16_operands_top1_accuracy"])
    for k in af.PATHS:
        g, w = got["paths"][k], want["paths"][k]
        assert g["top1_agreement"] == w["top1_agreement"], k
        for q in ("dprob_p50", "dprob_p99", "dprob_max"):
            assert abs(g[q] - w[q]) <= 1e-3, (k, q, g[q], w[q])
        assert g["oracle_operands"] == w["oracle_operands"]
        ge, we = g["exact_oracle"], w["exact_oracle"]
        assert ge["top1_agreement"] == we["top1_agreement"], k
        assert abs(ge["dprob_p99"] - we["dprob_p99"]) <= 1e-3, k


def test_record_meets_the_quicknet_gates(records):
    got, _, _ = records
    assert af.check_record("quicknet", got) == []


def test_check_record_reports_each_missed_gate(records):
    got, _, _ = records
    bad = {**got, "images": 256,
           "paths": {k: v for k, v in got["paths"].items()
                     if k != "packed_domain"}}
    bad["paths"]["packed_int8"] = dict(bad["paths"]["packed_int8"],
                                       top1_agreement=0.98, dprob_p99=0.6)
    failed = af.check_record("quicknet", bad)
    assert len(failed) == 4, failed
    assert af.check_record("binary_densenet28", dict(
        got, paths={**got["paths"], "packed_int8": dict(
            got["paths"]["packed_int8"], top1_agreement=0.86,
            dprob_p99=0.99)})) == []


def test_train_model_protocol_on_the_cpu(monkeypatch):
    """``train_model`` follows the JAX script: the same prototypes, steps,
    clip norm and seeds reach ``train_briefly``, and an oracle that does not
    separate the classes fails fast."""
    calls = {}

    def fake_train(spec, params, **kw):
        calls.update(kw)
        return params, {"loss_first": 2.0, "loss_last": 1.0}

    monkeypatch.setattr(af, "train_briefly", fake_train)
    monkeypatch.setitem(af.TRAIN_STEPS, "binary_densenet28", 1)
    with pytest.raises(RuntimeError, match="oracle accuracy"):
        af.train_model("binary_densenet28", device="cpu", spec=SPEC)
    assert calls["steps"] == 1 and calls["batch"] == 32
    assert calls["clip_norm"] == 1.0 and calls["num_classes"] == 8
    np.testing.assert_array_equal(
        calls["protos"], jmake_prototypes(1000, SPEC.input_size, 8))


def test_saved_params_convert_to_the_same_artifact(tmp_path):
    """``save_params`` keeps the binary kernels as their signs only: the
    tree ``load_params`` gives back converts to the same artifact, bit for
    bit, through the port and through the JAX package, and gives the same
    oracle logits."""
    params = _numpy(jinit(JSPEC, seed=3, randomize_bn=True))
    layers = convert_model(SPEC, params)
    path = tmp_path / "tiny.npz"
    af.save_params(path, af.Trained(SPEC, params, None, layers, None, {}))
    with np.load(path) as f:
        assert {k for k in f.files if k.endswith("@signs")} == {
            f"{n}/kernel@signs" for n, e in layers.items()
            if e["kind"] in ("bconv", "bdense")} != set()
    back = af.load_params(path)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for got, want in ((convert_model(SPEC, back), layers),
                      (jconvert(JSPEC, back), jconvert(JSPEC, params))):
        for name, entry in want.items():
            for k, v in entry.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[name][k], v,
                                                  err_msg=f"{name}/{k}")
    x = jnp.asarray(np.random.default_rng(4).normal(
        0, 1, (4, 32, 32, 3)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jfloat_apply(JSPEC, back, x)),
                                  np.asarray(jfloat_apply(JSPEC, params, x)))


def _mini_birealnet(b, x):
    """Bi-RealNet-18's topology at a reduced depth and width: a stem, then
    two stages of two blocks, each sign -> zero-padded binary 3x3 -> BN ->
    + the real shortcut (an average pool and a 1x1 conv where the stage
    downsamples)."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem_conv")
    x = b.max_pool(x, 3, 2)
    for s, f in enumerate((32, 64)):
        for i in range(2):
            stride = 2 if (s > 0 and i == 0) else 1
            if stride == 2:
                shortcut = b.conv_bn(b.avg_pool(x, 2, 2, padding="SAME"), f,
                                     1, name=f"shortcut_{s}")
            else:
                shortcut = x
            y = b.binary_conv_bn(x, f, 3, stride=stride, pad_value=0,
                                 name=f"stage_{s}_block_{i}")
            x = b.add(shortcut, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, 8, name="head")
    return b.softmax(x)


def test_mini_birealnet_int8_matches_jax():
    """The stage the card's Bi-RealNet-18 int8 record runs, at reduced
    depth: from JAX's calibrated ranges, the port's int8 forward (its zero-
    padded binary convs writing int8, the int8 ADDs of the real shortcuts)
    gives JAX's logits bit for bit, at the protocol's compute dtype."""
    jspec = JModelSpec("mini_birealnet", _mini_birealnet, input_size=(32, 32),
                       num_classes=8)
    spec = ModelSpec("mini_birealnet", _mini_birealnet, input_size=(32, 32),
                     num_classes=8)
    params = _numpy(jinit(jspec, seed=3, randomize_bn=True))
    rng = np.random.default_rng(4)
    calib = [rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)]
    in_r, out_r = jcalibrate(jspec, params, calib, with_outputs=True)
    jlayers8 = jconvert(jspec, params, int8_ranges=in_r, int8_out_ranges=out_r)
    layers8 = convert_model(spec, params, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    assert any("out_scale" in v for k, v in layers8.items()
               if k.startswith("stage_"))
    x = rng.normal(0, 1, (16, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jpacked_apply(jspec, jlayers8, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16,
                                    return_logits=True))
    got = packed_apply(spec, layers8, x, device="cpu",
                       return_logits=True).numpy()
    np.testing.assert_array_equal(got, want)


def _mini_alexnet(b, x):
    """BinaryAlexNet's topology at reduced widths: the float 11x11/4 stem,
    VALID max pools, a one-padded 5x5 and three 3x3 binary convs, two
    binary dense layers and the float head."""
    x = b.conv_bn(x, 24, 11, stride=4, name="stem_conv")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 5, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv4")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 256, name="fc1")
    x = b.binary_dense_bn(x, 256, name="fc2")
    x = b.dense(x, 8, name="head")
    return b.softmax(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mini_alexnet_packed_paths_match_jax(dtype):
    """The stages of the card's BinaryAlexNet record, at reduced widths: the
    port's packed float32 and bfloat16 forwards (the float domain and the
    packed domain) give JAX's logits from the same artifact within 1e-3
    (float32 convs summed in another order; bf16 stores of the same
    values), and the same top-1 on every image."""
    jspec = JModelSpec("mini_alexnet", _mini_alexnet, input_size=(67, 67),
                       num_classes=8)
    spec = ModelSpec("mini_alexnet", _mini_alexnet, input_size=(67, 67),
                     num_classes=8)
    layers = jconvert(jspec, _numpy(jinit(jspec, seed=5, randomize_bn=True)))
    x = np.random.default_rng(6).normal(0, 1, (32, 67, 67, 3)).astype(
        np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    for domain in ("float", "packed"):
        want = np.asarray(jpacked_apply(jspec, layers, jnp.asarray(x),
                                        compute_dtype=jdt, domain=domain,
                                        return_logits=True), np.float32)
        got = packed_apply(spec, layers, x, compute_dtype=tdt, device="cpu",
                           domain=domain, return_logits=True).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                   err_msg=domain)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
