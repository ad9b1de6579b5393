"""The port's tools (``compute_engine_tpu_torch.scripts``, ``.examples``) on
the CPU at small sizes, each against the JAX repo's counterpart, and the
reports the card wrote beside them.

Stated tolerances: float conv outputs within rtol 2e-5, atol 2e-4 of JAX's
(as tests/test_torch_bconv2d_packed.py); packed words, pooled words and
dequantized values equal; bytes and multiply-adds of the section floors
equal (the JAX floors times the JAX rates, to 1e-12 relative)."""

import dataclasses
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.core import (BConv2DParams as JBConv2DParams,
                                     OutputTransform as JOutputTransform,
                                     Padding as JPadding,
                                     compute_output_thresholds as jthresholds,
                                     fuse_output_transform as jfuse)
from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet
from compute_engine_tpu.ops import (bconv2d as jbconv2d,
                                    bmaxpool2d as jbmaxpool2d,
                                    dequantize as jdequantize,
                                    quantize as jquantize)

from compute_engine_tpu_torch.core import (BConv2DParams, Padding, bitpack,
                                           fuse_output_transform)
from compute_engine_tpu_torch.examples import e2e_smoke
from compute_engine_tpu_torch.models import (get_model, init_model,
                                             tiny_quicknet)
from compute_engine_tpu_torch.ops import bconv2d
from compute_engine_tpu_torch.parallel.mesh import device_slots
from compute_engine_tpu_torch.scripts import baseline_matrix as bm
from compute_engine_tpu_torch.scripts import section_profile as sp
from compute_engine_tpu_torch.scripts import tp_scaling_report as tsr

REPO = pathlib.Path(__file__).parents[1]
TOOLS = REPO / "compute_engine_tpu_torch" / "scripts"
FLOAT_TOL = dict(rtol=2e-5, atol=2e-4)
KW = dict(section_filters=(32, 64), section_blocks=(1, 1), num_classes=8,
          input_size=32)
SPEC, JSPEC = tiny_quicknet(**KW), jtiny_quicknet(**KW)


def _load_jax_script(name):
    """One of the JAX repo's scripts/ as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", str(REPO / "scripts" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the example --------------------------------------------------------------


@pytest.fixture(scope="module")
def example():
    return e2e_smoke.run("cpu")


def _jax_example():
    """examples/e2e_smoke.py of the JAX repo, on the same numpy inputs."""
    x, w, post_mul, post_bias = e2e_smoke.inputs()
    params = JBConv2DParams(channels_in=64, padding=JPadding.SAME,
                            pad_value=1)
    t = jfuse(post_mul, post_bias, 3 * 3 * 64)
    xp, wp = jquantize(jnp.asarray(x)), jquantize(jnp.asarray(w))
    floats = np.asarray(jbconv2d(xp, wp, t, params, "float",
                                 kernel="reference"))
    thr = jthresholds(post_mul, post_bias, 3 * 3 * 64)
    wflip = w * np.where(post_mul >= 0, 1.0, -1.0)[:, None, None, None]
    packed = jbconv2d(xp, jquantize(jnp.asarray(wflip)),
                      JOutputTransform(thresholds=thr), params, "bitpacked",
                      kernel="reference")
    pooled = jbmaxpool2d(packed, 2, 2)
    return (floats, np.asarray(packed), np.asarray(pooled),
            np.asarray(jdequantize(pooled, 128)))


def _words(a):
    """Packed words as uint32 (the port stores int32, JAX uint32)."""
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a).view(
        np.uint32)


def test_example_against_jax(example):
    floats, packed, pooled, deq = _jax_example()
    for k in e2e_smoke.KERNELS:
        np.testing.assert_allclose(example["float"][k].numpy(), floats,
                                   **FLOAT_TOL, err_msg=k)
        np.testing.assert_array_equal(_words(example["bitpacked"][k]),
                                      _words(packed), err_msg=k)
    np.testing.assert_array_equal(_words(example["pooled"]), _words(pooled))
    np.testing.assert_array_equal(example["dequantized"].numpy(), deq)


def test_example_lowerings_equal_the_reference(example):
    assert e2e_smoke.unequal(example) == []
    broken = {**example, "float": dict(example["float"])}
    broken["float"]["mxu"] = broken["float"]["mxu"] + 1
    assert e2e_smoke.unequal(broken) == [("float", "mxu")]


def test_example_main_exits_zero_on_the_cpu(capsys):
    assert e2e_smoke.main(["--device", "cpu"]) == 0
    assert "every lowering equal" in capsys.readouterr().out


# -- the section profile -------------------------------------------------------


@pytest.mark.parametrize("name", sp.ROWS)
def test_section_floors_are_the_jax_scripts(name):
    """Bytes and multiply-adds of every row at b128 are those of the JAX
    script's floors (its seconds times its rates); only the rates differ."""
    jsp = _load_jax_script("section_profile")
    jmac_s, jhbm_s, _ = jsp.floors(name, 128)
    f = sp.floors(name, 128)
    jrate = (jsp.INT8_MAC_PER_S if name.startswith("section")
             else jsp.BF16_MAC_PER_S)
    assert f["macs"] == pytest.approx(jmac_s * jrate, rel=1e-12)
    assert f["bytes"] == pytest.approx(jhbm_s * jsp.HBM_B_PER_S, rel=1e-12)
    assert f["hbm_floor_s"] == f["bytes"] / sp.HBM_B_PER_S
    # The binary convs at the one-bit rate, every other op at bf16's.
    assert f["mac_floor_s"] == pytest.approx(
        f["binary_macs"] / sp.ONE_BIT_MAC_PER_S
        + (f["macs"] - f["binary_macs"]) / sp.BF16_MAC_PER_S, rel=1e-12)
    if name.startswith("section"):
        assert f["binary_macs"] == jsp.section_macs(int(name[-1]), 128)


def test_section_rates_are_the_h100_data_sheets():
    assert sp.HBM_B_PER_S == 3.35e12
    assert sp.INT8_MAC_PER_S == 989.5e12
    assert sp.BF16_MAC_PER_S == 494.7e12
    assert sp.ONE_BIT_MAC_PER_S == 8 * sp.INT8_MAC_PER_S


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.shape(tree)}


def test_full_prefix_is_the_zoo_quicknet():
    """The prefix with every stem op, section and the head has the zoo
    QuickNet's parameter names and shapes; each shorter prefix a subset."""
    full = _shapes(init_model(sp.make_prefix_spec(3, 4, True), seed=0))
    assert full == _shapes(init_model(get_model("quicknet"), seed=0))
    labels = [label for label, _ in sp.prefixes()]
    assert [label.lstrip("+") for label in labels] == list(sp.ROWS)
    last = set()
    for _, spec in sp.prefixes():
        names = set(_shapes(init_model(spec, seed=0)))
        assert last < names <= set(full)
        last = names


def test_section_profile_reads_the_card_only():
    with pytest.raises(ValueError, match="device time"):
        sp.profile(2, device="cpu")


def test_section_bad_rows():
    rows = [{"name": "a", "pct_of_bound": 40.0},
            {"name": "b", "pct_of_bound": 105.5},
            {"name": "c", "pct_of_bound": None}]
    assert sp.bad_rows({"sections": rows}) == ["b", "c"]


# -- the baseline matrix -------------------------------------------------------


def _stub_benchmark_model(monkeypatch):
    """``benchmark_model`` times only the card: a stub with its documented
    keys, recording how it was called."""
    calls = []

    def stub(model, batch, iters, warmup, repeats, kernel, int8_pipeline,
             device, device_busy):
        calls.append(dict(model=model, batch=batch, iters=iters,
                          repeats=repeats, kernel=kernel,
                          int8_pipeline=int8_pipeline, device_busy=device_busy))
        return {"model": model.name, "batch": batch, "kernel": kernel,
                "compute_dtype": "bfloat16", "domain": "float",
                "int8_pipeline": int8_pipeline, "device": "card",
                "compile_s": 1.5, "latency_ms_p50": 4.0,
                "latency_ms_mean": 4.2, "latency_ms_min": 3.5,
                "images_per_sec": batch / 4e-3, "weights_mb": 0.25,
                "input_mb": 0.01, "act_peak_mb": 0.5, "peak_hbm_mb": 9.0,
                "device_busy_ms": 0.75}

    monkeypatch.setattr(bm, "benchmark_model", stub)
    return calls


def test_bench_config_keys_are_the_jax_scripts(monkeypatch):
    """A tiny spec: the record ``bench_config`` assembles from
    ``benchmark_model`` has the JAX script's record keys, ``compile_s``
    among them, with the measured peak HBM in place of JAX's estimate and
    the device-busy time beside the latency."""
    calls = _stub_benchmark_model(monkeypatch)
    jbm = _load_jax_script("baseline_matrix")
    want = jbm.bench_config(JSPEC, 2, iters=2, repeats=1)
    got = bm.bench_config(SPEC, 2, iters=2, repeats=1)
    assert calls == [dict(model=SPEC, batch=2, iters=2, repeats=1,
                          kernel="auto", int8_pipeline=False,
                          device_busy=True)]
    assert set(got) == ((set(want) - {"peak_hbm_est_mb"})
                        | {"device_busy_ms", "peak_hbm_mb"})
    assert got["model"] == SPEC.name  # JAX's record holds what it was given
    assert want["model"] is JSPEC
    assert got["batch"] == 2 and got["iters"] == 2
    assert got["latency_ms_p50"] == 4.0 and got["per_image_ms_p50"] == 2.0
    assert (got["device_busy_ms"], got["compile_s"]) == (0.75, 1.5)
    assert (got["weights_mb"], got["peak_hbm_mb"]) == (0.25, 9.0)


def test_bench_config_int8_and_reference_column(monkeypatch):
    calls = _stub_benchmark_model(monkeypatch)
    got = bm.bench_config(SPEC, 1, iters=1, repeats=1, int8=True)
    assert calls[0]["int8_pipeline"] and got["pipeline"] == "int8"
    assert "ref_m1_1thread_ms" not in got  # no published tiny model
    got = bm.bench_config(dataclasses.replace(SPEC, name="quicknet"), 1, iters=1,
                          repeats=1)
    assert got["ref_m1_1thread_ms"] == 5.8
    assert got["speedup_vs_ref_m1"] == 5.8 / 4.0
    assert bm.REF_BATCH1_MS["quicknet"] == 5.8
    assert bm.REF_BATCH1_MS["birealnet18"] == pytest.approx(41.6 * 5.8 / 25.5)


def test_bench_serving_results_equal_the_direct_forward():
    rec = bm.bench_serving(SPEC, batch_size=4, n_clients=4, duration_s=1.0,
                           device="cpu")
    assert rec["results_equal_direct"] and rec["results_unequal"] == 0
    assert rec["requests"] > 0 and rec["batches"] > 0
    assert 0 < rec["mean_batch_fill"] <= 1
    assert rec["request_p50_ms"] <= rec["request_p99_ms"]
    assert bm.bad_rows({"s": rec}) == []


def test_parse_configs_and_bad_rows():
    assert bm.parse_configs("quicknet:128,quicknet:1:int8,serving") == (
        [("quicknet", 128, False), ("quicknet", 1, True)], True)
    rows = {"_meta": {}, "a": {"latency_ms_p50": 1.0, "images_per_sec": 2.0,
                               "device_busy_ms": 0.5},
            "b": {"latency_ms_p50": float("nan"), "images_per_sec": 2.0},
            "c": {"requests_per_sec": 3.0, "results_equal_direct": False}}
    assert bm.bad_rows(rows) == ["b", "c"]


# -- the scaling report --------------------------------------------------------


def test_tp_modes_equal_one_slot_and_jax():
    """Every mode over 2 and 4 CPU slots equals ``ops.bconv2d`` on one slot,
    and that equals JAX's ``bconv2d`` on the same packed inputs."""
    shape = (4, 6, 6, 64)
    rows = tsr.tp_modes(shape, tps=(2, 4), reps=1, device="cpu")
    assert [(r["tp"], r["mode"]) for r in rows] == [
        (tp, m) for tp in (2, 4) for m in tsr.MODES]
    assert all(r["equal_single_slot"] for r in rows)
    assert all(r["slots"] == f"cpu x {r['tp']}" for r in rows)
    x, filt, post_mul, post_bias = tsr.tp_inputs(shape)
    c = shape[-1]
    got = bconv2d(bitpack(torch.from_numpy(x)), bitpack(torch.from_numpy(
        filt)), fuse_output_transform(post_mul, post_bias, 9 * c),
        BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1),
        "float")
    want = jbconv2d(jquantize(jnp.asarray(x)), jquantize(jnp.asarray(filt)),
                    jfuse(post_mul, post_bias, 9 * c),
                    JBConv2DParams(channels_in=c, padding=JPadding.SAME,
                                   pad_value=1), "float", kernel="reference")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)


def test_dp_scaling_one_row_per_dp():
    rows = tsr.dp_scaling(SPEC, per_group=2, dps=(1, 2, 4), reps=1,
                          device="cpu")
    assert [r["dp"] for r in rows] == [1, 2, 4]
    assert [r["batch"] for r in rows] == [2, 4, 8]
    assert rows[0]["scaling_efficiency"] == 1.0
    for r in rows:
        assert math.isfinite(r["images_per_sec"]) and r["images_per_sec"] > 0
        assert r["device_busy_ms"] is None and r["slots"] == f"cpu x {r['dp']}"


def test_device_slots():
    assert device_slots(3, "cpu") == ([torch.device("cpu")] * 3, "cpu x 3")


# -- the reports the card wrote -----------------------------------------------


def _report(name):
    with open(TOOLS / name) as f:
        return json.load(f)


def _names_the_card(text):
    assert text.startswith("NVIDIA") and text.endswith("W"), text


def test_committed_baseline_matrix():
    data = _report("baseline_matrix_h100.json")
    _names_the_card(data["_meta"]["card"])
    want = {f"{m}@{b}" for m, b in bm.DEFAULT_CONFIGS}
    want |= {f"{m}@{b}@int8" for m, b, _ in bm.INT8_CONFIGS}
    want.add("binary_densenet45@serving")
    assert want <= set(data)
    assert bm.bad_rows(data) == []
    served = data["binary_densenet45@serving"]
    assert served["batch_size"] == 128 and served["n_clients"] == 256
    assert 0 < served["mean_batch_fill"] <= 1


def test_committed_section_profile():
    report = _report("section_profile_h100.json")
    _names_the_card(report["card"])
    assert [r["name"] for r in report["sections"]] == list(sp.ROWS)
    assert sp.bad_rows(report) == []
    for r in report["sections"]:
        f = sp.floors(r["name"], report["batch"])
        assert r["bytes"] == f["bytes"] and r["macs"] == f["macs"]
    total = sum(r["ms"] for r in report["sections"])
    assert total == pytest.approx(report["whole_model"]["ms"], rel=1e-9)


def test_committed_tp_scaling():
    report = _report("tp_scaling_h100.json")
    _names_the_card(report["card"])
    assert [r["dp"] for r in report["dp_scaling"]] == [1, 2, 4]
    assert {(r["tp"], r["mode"]) for r in report["tp_modes"]} == {
        (tp, m) for tp in (2, 4) for m in tsr.MODES}
    assert all(r["equal_single_slot"] and r["bit_exact_vs_gather"]
               for r in report["tp_modes"])
    for r in report["dp_scaling"] + report["tp_modes"]:
        assert (r["latency_ms"] > 0 and math.isfinite(r["latency_ms"])
                and r["slots"] and r["compile_s"] > 0)
    # Compiled on the card: one graph a call where every slot is one card.
    assert all(r["case"] == "A" and r["host_steps"] == 1
               for r in report["dp_scaling"] if "x" in r["slots"]
               or r["dp"] == 1)


# -- runtime.benchmark: JAX's defaults and command line ------------------------

_RESULT = {"model": "quicknet", "batch": 8, "kernel": "auto",
           "latency_ms_p50": 1.25, "images_per_sec": 6400.0,
           "compute_dtype": "bfloat16", "device_busy_ms": None}


def _stub_runtime_benchmark(monkeypatch, module):
    """``module.benchmark_model`` replaced by a stub that records its
    keyword arguments and returns ``_RESULT``."""
    calls = []

    def stub(**kw):
        calls.append(kw)
        return dict(_RESULT)

    monkeypatch.setattr(module, "benchmark_model", stub)
    return calls


@pytest.mark.parametrize("argv", [[], ["--json"]])
def test_benchmark_cli_takes_jaxs_defaults(monkeypatch, capsys, argv):
    """``python -m ...runtime.benchmark`` and JAX's CLI, both over a stubbed
    ``benchmark_model``: the same batch, iterations and warm-up by default;
    without ``--json`` both print the key/value table, with it one JSON
    line."""
    import compute_engine_tpu.runtime.benchmark as jrbm

    from compute_engine_tpu_torch.runtime import benchmark as rbm

    jcalls = _stub_runtime_benchmark(monkeypatch, jrbm)
    calls = _stub_runtime_benchmark(monkeypatch, rbm)
    jrbm.main(argv)
    want = capsys.readouterr().out
    rbm.main(argv)
    got = capsys.readouterr().out
    assert got == want
    if argv:
        assert json.loads(got) == _RESULT
    else:
        assert got.splitlines()[0] == f"{'model':18s} quicknet"
    for key in ("batch", "iters", "warmup", "kernel", "int8_pipeline",
                "domain"):
        assert calls[0][key] == jcalls[0][key], key
    assert (calls[0]["batch"], calls[0]["warmup"]) == (8, 3)


def test_benchmark_model_signature_is_jaxs():
    """``benchmark_model()`` times JAX's batch after JAX's warm-up, and
    takes ``binary_dtype``."""
    import inspect

    import compute_engine_tpu.runtime.benchmark as jrbm

    from compute_engine_tpu_torch.runtime import benchmark as rbm

    want = inspect.signature(jrbm.benchmark_model).parameters
    got = inspect.signature(rbm.benchmark_model).parameters
    for key in ("batch", "iters", "warmup", "repeats", "kernel", "seed",
                "artifact_path", "input_size", "int8_pipeline", "domain"):
        assert got[key].default == want[key].default, key
    assert "binary_dtype" in got


def test_benchmark_model_accepts_binary_dtype(monkeypatch):
    """On the stand-in card: ``binary_dtype`` (a TPU operand type) is taken
    and changes nothing."""
    import _torch_card_standins as standins
    from _torch_card_standins import FakeEvent

    from compute_engine_tpu_torch.runtime import benchmark as rbm

    standins.install(monkeypatch)
    prepare = rbm.prepare_forward
    monkeypatch.setattr(rbm, "resolve_device", torch.device)
    monkeypatch.setattr(rbm, "prepare_forward",
                        lambda *a: prepare(*a[:7], "cpu", *a[8:]))
    got = []
    for dtype in (None, jnp.int8):
        FakeEvent.queue = [1.0, 2.5] * 2
        kw = {} if dtype is None else {"binary_dtype": dtype}
        got.append(rbm.benchmark_model(SPEC, batch=2, iters=1, repeats=2,
                                       **kw))
    for r in got:
        r.pop("compile_s")
    assert got[0] == got[1]
    assert got[0]["latency_ms_p50"] == 1.5


def test_int8_pipeline_with_an_artifact_is_ignored(tmp_path):
    """As JAX's: an artifact is timed as it was converted, and
    ``int8_pipeline`` beside it is ignored (the forward is the artifact's,
    no calibration runs)."""
    from compute_engine_tpu_torch.converter import save_artifact
    from compute_engine_tpu_torch.models import convert_model
    from compute_engine_tpu_torch.runtime import benchmark as rbm

    path = str(tmp_path / "tiny.npz")
    save_artifact(path, convert_model(SPEC, init_model(SPEC, seed=3,
                                                       randomize_bn=True)),
                  SPEC.name)
    outs = []
    for int8 in (False, True):
        spec, layers, x, forward = rbm.prepare_forward(
            SPEC, batch=2, artifact_path=path, device="cpu",
            int8_pipeline=int8)
        assert not any("kernel_int8" in e for e in layers.values())
        outs.append(forward())
    assert torch.equal(outs[0], outs[1])
