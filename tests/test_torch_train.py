"""Brief training in the port (``models/train.py``, on the CPU) against the
JAX package, the in-suite accuracy gates of tests/test_accuracy_fixtures.py
with weights trained by the port, and the accuracy record the card wrote
(tests/fixtures/torch_accuracy_224.json)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from compute_engine_tpu.models import (float_apply as jfloat_apply,
                                       init_model as jinit,
                                       tiny_quicknet as jtiny_quicknet,
                                       train_briefly as jtrain_briefly)
from compute_engine_tpu.models.train import (
    TrainBuilder as JTrainBuilder,
    clustered_batch as jclustered_batch,
    make_prototypes as jmake_prototypes,
    recalibrate_bn_stats as jrecalibrate)

from compute_engine_tpu_torch.models import (calibrate_model, convert_model,
                                             float_apply, init_model,
                                             packed_apply, tiny_quicknet,
                                             train_briefly)
from compute_engine_tpu_torch.models.train import (TrainBuilder,
                                                   clustered_batch,
                                                   make_prototypes,
                                                   recalibrate_bn_stats,
                                                   synthetic_clustered)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_accuracy_224.json")

N_CLASSES = 8
KW = dict(section_filters=(32, 64), section_blocks=(1, 1),
          num_classes=N_CLASSES, input_size=32)
SPEC, JSPEC = tiny_quicknet(**KW), jtiny_quicknet(**KW)

# Stated tolerances: the forward and its batch statistics (float32, the two
# packages summing in different orders), and the gradients (which also run
# through every BN's backward).
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_data_match_jax():
    protos = make_prototypes(7, (32, 32), N_CLASSES)
    np.testing.assert_array_equal(
        protos, jmake_prototypes(7, (32, 32), N_CLASSES))
    for a, b in zip(
            [clustered_batch(protos, np.random.default_rng(3), 16, 0.2)],
            [jclustered_batch(protos, np.random.default_rng(3), 16, 0.2)]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    ours = synthetic_clustered(np.random.default_rng(5), 4, (8, 8), 3)
    from compute_engine_tpu.models.train import synthetic_clustered as jsc
    theirs = jsc(np.random.default_rng(5), 4, (8, 8), 3)
    for _ in range(3):
        (xa, ya), (xb, yb) = next(ours), next(theirs)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.fixture(scope="module")
def setup():
    """Random-BN params (numpy) and one clustered batch. Seed 1: no binary
    layer's pre-activation lies within float32 rounding of 0 (or of the STE's
    +-1 gradient clip) in either package, so the signs, and the gradient
    masks, are the same in both."""
    params = _numpy_tree(jinit(JSPEC, seed=1, randomize_bn=True))
    protos = make_prototypes(7, (32, 32), N_CLASSES)
    x, y = clustered_batch(protos, np.random.default_rng(1), 16)
    return params, x, y


def test_train_builder_matches_jax(setup):
    params, x, y = setup
    jb = JTrainBuilder(jax.tree_util.tree_map(jnp.asarray, params))
    want = np.asarray(JSPEC.forward(jb, jnp.asarray(x)))
    b = TrainBuilder(params)
    got = SPEC.forward(b, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **FORWARD_TOL)
    assert b.batch_stats.keys() == jb.batch_stats.keys()
    for name, (mean, var) in b.batch_stats.items():
        jmean, jvar = jb.batch_stats[name]
        np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                                   **FORWARD_TOL, err_msg=name)
        np.testing.assert_allclose(var.detach().numpy(), np.asarray(jvar),
                                   **FORWARD_TOL, err_msg=name)


def test_loss_and_gradients_match_jax(setup):
    params, x, y = setup

    def jloss(p):
        logits = JSPEC.forward(JTrainBuilder(p), jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jl, jgrads = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    p = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), params)
    logits = SPEC.forward(TrainBuilder(p), torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **GRAD_TOL)
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    n = 0
    for path, t in _flat(p):
        g = (t.grad.numpy() if t.grad is not None
             else np.zeros(t.shape, np.float32))
        np.testing.assert_allclose(g, want[path], **GRAD_TOL, err_msg=path)
        n += int(np.abs(want[path]).max() > 0)
    assert n > 10  # the gradients are not all zero


def test_recalibrate_bn_stats_matches_jax(setup):
    params, _, _ = setup
    protos = make_prototypes(9, (32, 32), N_CLASSES)
    rng = np.random.default_rng(4)
    batches = [clustered_batch(protos, rng, 16)[0] for _ in range(3)]
    want = jrecalibrate(JSPEC, params, batches)
    got = recalibrate_bn_stats(SPEC, params, batches, device="cpu")
    for path, w in _flat(want):
        np.testing.assert_allclose(dict(_flat(got))[path], w, **FORWARD_TOL,
                                   err_msg=path)


def test_train_briefly_step_matches_jax(setup):
    """One step from the same params on the same batch: the same loss and
    the same Keras moving statistics (``m * old + (1 - m) * batch``), and
    Adam with optax's defaults moves the parameters alike. Adam's first
    step moves a parameter by about ``lr`` times the sign of its gradient,
    so a gradient within rounding of 0 may move it the other way, and one
    of order eps=1e-8 by any fraction of ``lr``: all parameters agree within
    ``2 * lr`` and 97% of them within 1e-6 (98.7% at this seed)."""
    params, _, _ = setup
    protos = make_prototypes(7, (32, 32), N_CLASSES)
    lr = 1e-3
    kw = dict(steps=1, batch=16, seed=2, protos=protos, lr=lr)
    want, jinfo = jtrain_briefly(JSPEC, params, **kw)
    got, info = train_briefly(SPEC, params, device="cpu", **kw)
    np.testing.assert_allclose(info["loss_first"], jinfo["loss_first"],
                               **GRAD_TOL)
    got, close, total = dict(_flat(got)), 0, 0
    for path, w in _flat(want):
        if "moving_" in path:
            np.testing.assert_allclose(got[path], w, **FORWARD_TOL,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=2 * lr * 1.001, err_msg=path)
            close += int((np.abs(got[path] - w) <= 1e-6).sum())
            total += w.size
    assert close >= 0.97 * total, (close, total)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """The global-norm clip of ``train_briefly(clip_norm=)`` is optax's:
    scaled by ``max_norm / norm`` at or above ``max_norm`` (no epsilon),
    untouched below; zero leaves (a moving statistic's) change nothing."""
    from compute_engine_tpu_torch.models.train import clip_by_global_norm

    rng = np.random.default_rng(11)
    tree = {"a": rng.normal(0, 1, (7, 5)).astype(np.float32),
            "b": rng.normal(0, 3, (11,)).astype(np.float32),
            "moving_mean": np.zeros(4, np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree_util.tree_map(jnp.asarray, tree), optax.EmptyState())
    grads = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    norm = clip_by_global_norm([grads["a"], grads["b"]], max_norm)
    assert float(norm) == pytest.approx(float(optax.global_norm(tree)),
                                        rel=1e-6)
    assert (float(norm) >= max_norm) == (max_norm == 0.5)
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=0, err_msg=k)


def test_train_briefly_clipped_matches_jax(setup):
    """Three steps with a clip norm that every step reaches: the same losses
    as JAX's optax chain (clip, then Adam), to the gradients' tolerance."""
    params, _, _ = setup
    protos = make_prototypes(7, (32, 32), N_CLASSES)
    kw = dict(steps=3, batch=16, seed=2, protos=protos, lr=1e-3,
              clip_norm=1e-3)
    _, jinfo = jtrain_briefly(JSPEC, params, **kw)
    _, info = train_briefly(SPEC, params, device="cpu", **kw)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(info[k], jinfo[k], **GRAD_TOL)


def test_deterministic_scopes_and_restores():
    """``device.deterministic`` turns deterministic algorithms on for the
    block (training and precise BN run inside it) and restores the caller's
    settings, also after an error."""
    import os

    from compute_engine_tpu_torch.device import deterministic

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    with pytest.raises(KeyError):
        with deterministic():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
            raise KeyError
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == before


def test_train_briefly_is_a_function_of_its_seed():
    """Two trainings from one seed end in the same weights, bit for bit."""
    protos = make_prototypes(7, (32, 32), N_CLASSES)
    kw = dict(steps=3, batch=16, seed=2, protos=protos, clip_norm=1.0,
              device="cpu")
    params = init_model(SPEC, seed=0)
    a, info_a = train_briefly(SPEC, params, **kw)
    b, info_b = train_briefly(SPEC, params, **kw)
    assert info_a == info_b
    for (path, x), (_, y) in zip(_flat(a), _flat(b)):
        np.testing.assert_array_equal(x, y, err_msg=path)


# -- the in-suite accuracy gates (tests/test_accuracy_fixtures.py:38-135),
#    trained by the port ------------------------------------------------------


def _agreement(got, oracle):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float((got.argmax(-1) == oracle.argmax(-1)).mean())


@pytest.fixture(scope="module")
def trained_setup():
    protos = make_prototypes(7, SPEC.input_size, N_CLASSES)
    params = init_model(SPEC, seed=0)
    trained, info = train_briefly(SPEC, params, steps=60, batch=64, seed=0,
                                  protos=protos, device="cpu")
    assert info["loss_last"] < 0.6 * info["loss_first"], info
    x, y = clustered_batch(protos, np.random.default_rng(123), 512)
    with torch.no_grad():
        oracle = float_apply(SPEC, trained, x, device="cpu").numpy()
    assert (oracle.argmax(-1) == y).mean() >= 0.99
    return trained, protos, x, y, oracle


def test_trained_packed_paths_top1_agreement(trained_setup):
    trained, protos, x, y, oracle = trained_setup
    layers = convert_model(SPEC, trained)
    for kw in (dict(compute_dtype=torch.float32),
               dict(compute_dtype=torch.bfloat16),
               dict(compute_dtype=torch.bfloat16, domain="packed")):
        assert _agreement(packed_apply(SPEC, layers, x, device="cpu", **kw),
                          oracle) >= 0.99, kw


def test_trained_int8_pipeline_top1_agreement(trained_setup):
    trained, protos, x, y, oracle = trained_setup
    in_r, out_r = calibrate_model(
        SPEC, trained,
        [clustered_batch(protos, np.random.default_rng(5), 64)[0]],
        with_outputs=True, device="cpu")
    layers8 = convert_model(SPEC, trained, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    assert _agreement(packed_apply(SPEC, layers8, x, device="cpu"),
                      oracle) >= 0.98


def test_bn_recalibration_precise_bn(trained_setup):
    """recalibrate_bn_stats keeps the oracle's accuracy and writes exactly
    the aggregated train-mode batch statistics of the calibration set."""
    trained, protos, x, y, oracle = trained_setup
    rng = np.random.default_rng(77)
    batches = [clustered_batch(protos, rng, 64)[0] for _ in range(8)]
    recal = recalibrate_bn_stats(SPEC, trained, batches, device="cpu")
    with torch.no_grad():
        got = float_apply(SPEC, recal, x, device="cpu").numpy()
    assert (got.argmax(-1) == y).mean() >= 0.99
    collected = {}
    with torch.no_grad():
        for xb in batches:
            b = TrainBuilder(trained)
            SPEC.forward(b, torch.from_numpy(xb))
            for name, (mean, var) in b.batch_stats.items():
                collected.setdefault(name, []).append(
                    (mean.numpy(), var.numpy()))
    for name, mv in collected.items():
        means = np.stack([m for m, _ in mv])
        bvars = np.stack([v for _, v in mv])
        np.testing.assert_allclose(recal[name]["bn"]["moving_mean"],
                                   means.mean(0), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(recal[name]["bn"]["moving_variance"],
                                   bvars.mean(0) + means.var(0),
                                   rtol=1e-4, atol=1e-5)


def test_evaluate_harness_end_to_end(trained_setup):
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.evaluate import evaluate

    trained, protos, x, y, oracle = trained_setup
    interp = Interpreter(SPEC, convert_model(SPEC, trained), device="cpu")
    rng = np.random.default_rng(9)
    batches = [clustered_batch(protos, rng, 64) for _ in range(8)]
    result = evaluate(interp.predict, batches, progress_every=0)
    assert result["images"] == 512
    assert result["top1"] >= 0.99
    assert result["top5"] >= result["top1"]


def test_jax_trained_params_carried_across():
    """Params trained by JAX: the port's packed paths agree with JAX's float
    oracle at the same thresholds."""
    protos = jmake_prototypes(7, JSPEC.input_size, N_CLASSES)
    trained, info = jtrain_briefly(JSPEC, jinit(JSPEC, seed=0), steps=60,
                                   batch=64, seed=0, protos=protos)
    x, y = jclustered_batch(protos, np.random.default_rng(123), 512)
    oracle = np.asarray(jfloat_apply(JSPEC, trained, jnp.asarray(x)))
    assert (oracle.argmax(-1) == y).mean() >= 0.99
    layers = convert_model(SPEC, trained)
    for kw in (dict(compute_dtype=torch.float32),
               dict(compute_dtype=torch.bfloat16),
               dict(compute_dtype=torch.bfloat16, domain="packed")):
        assert _agreement(packed_apply(SPEC, layers, x, device="cpu", **kw),
                          oracle) >= 0.99, kw
    in_r, out_r = calibrate_model(
        SPEC, trained,
        [jclustered_batch(protos, np.random.default_rng(5), 64)[0]],
        with_outputs=True, device="cpu")
    layers8 = convert_model(SPEC, trained, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    assert _agreement(packed_apply(SPEC, layers8, x, device="cpu"),
                      oracle) >= 0.98


# -- the card's 224x224 record ------------------------------------------------


# The per-model gates of tests/test_accuracy_fixtures.py, copied: the least
# top-1 agreement with the float oracle and the largest p99 of the per-image
# max |dprob| of each path.
_GATES = {
    "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                      "packed_int8": 0.99, "packed_domain": 0.99},
    "dprob_p99": {"packed_f32": 0.05, "packed_bf16": 0.3,
                  "packed_int8": 0.5, "packed_domain": 0.3},
}
CARD_GATES = {
    "quicknet": _GATES,
    "birealnet18": _GATES,
    "binary_alexnet": {
        "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                          "packed_int8": 0.97, "packed_domain": 0.99},
        "dprob_p99": {"packed_f32": 0.5, "packed_bf16": 0.5,
                      "packed_int8": 0.85, "packed_domain": 0.5},
    },
    "binary_densenet28": {
        "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                          "packed_int8": 0.85, "packed_domain": 0.99},
        "dprob_p99": {"packed_f32": 0.05, "packed_bf16": 0.3,
                      "packed_int8": 1.0, "packed_domain": 0.3},
    },
}


@pytest.mark.parametrize("model", sorted(CARD_GATES))
def test_committed_card_record(model):
    """Each flagship model trained at full width on the card and held
    against every path there (``scripts.accuracy_fixtures``), under the JAX
    package's per-model gates: the float32 path against the float32 oracle,
    the bfloat16, int8 and packed-domain paths against the oracle with
    bfloat16 operands in its float convs and dense layers, as on the TPU
    where the gates were set. Every path, the packed domain included, is
    mandatory, and so is its reading against the float32 oracle; a lost
    record fails, it never skips."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    meta = fx["_meta"]
    assert meta["card"].startswith("NVIDIA") and meta["card"].endswith("W")
    assert "recipe" in meta
    assert model in fx, f"the card's {model} record is missing"
    rec = fx[model]
    assert rec["images"] >= 512
    assert rec["oracle"]["top1_accuracy"] >= 0.95
    gates = CARD_GATES[model]
    assert set(rec["paths"]) == set(gates["min_agreement"])
    for path, least in gates["min_agreement"].items():
        assert rec["paths"][path]["top1_agreement"] >= least, path
        assert rec["paths"][path]["dprob_p99"] <= gates["dprob_p99"][path], \
            path
        assert rec["paths"][path]["oracle_operands"] == (
            "float32" if path == "packed_f32" else "bfloat16"), path
        exact = rec["paths"][path]["exact_oracle"]
        assert 0 < exact["top1_agreement"] <= 1 and exact["dprob_p99"] >= 0
    assert rec["paths"]["packed_f32"]["exact_oracle"] == {
        k: rec["paths"]["packed_f32"][k] for k in ("top1_agreement",
                                                   "dprob_p99")}
    logits = np.asarray(rec["oracle"]["first_logits_4x16"])
    assert logits.shape == (4, 16) and np.isfinite(logits).all()
    assert rec["train_loss"]["loss_last"] < rec["train_loss"]["loss_first"]
    assert rec["seconds_per_train_step"] > 0


def test_accuracy_fixtures_gates_are_jax_gates():
    """The gates the card's run applies (``accuracy_fixtures.GATES``) are
    the JAX package's, as copied above."""
    from compute_engine_tpu_torch.scripts import accuracy_fixtures

    assert accuracy_fixtures.GATES == CARD_GATES
