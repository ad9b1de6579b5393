"""The two converter CLIs on the same arguments: byte-equal arrays, agreeing
headers and the same printed JSON line. The port calibrates on the CPU here."""

import json

import numpy as np
import pytest

from compute_engine_tpu.converter import load_artifact as jload
from compute_engine_tpu.converter.cli import main as jmain
from compute_engine_tpu.models import (calibrate_model as jcalibrate,
                                       convert_model as jconvert,
                                       get_model as jget_model,
                                       init_model as jinit,
                                       tiny_quicknet as jtiny_quicknet)

from compute_engine_tpu_torch.converter import load_artifact
from compute_engine_tpu_torch.converter.cli import main
from compute_engine_tpu_torch.models import convert_model, get_model
from compute_engine_tpu_torch.models import zoo

import _torch_parity as parity

HEADER_KEYS = ("source", "int8", "input_size", "num_classes")


def _run(cli, capsys, argv):
    """The CLI's last printed line, parsed."""
    capsys.readouterr()
    cli(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same(printed, jprinted):
    """The printed JSON agrees in keys and values, but for the path."""
    assert printed.keys() == jprinted.keys()
    for k in printed:
        if k != "output":
            assert printed[k] == jprinted[k], k


@pytest.mark.parametrize("model", ["quicknet", "binary_alexnet"])
def test_random_init_artifacts_are_byte_equal(tmp_path, capsys, model):
    path, jpath = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    printed = _run(main, capsys,
                   ["--model", model, "--output", path, "--seed", "0"])
    jprinted = _run(jmain, capsys,
                    ["--model", model, "--output", jpath, "--seed", "0"])
    _same(printed, jprinted)
    assert printed["output"] == path and printed["int8"] is False
    assert printed["binary_layers"] > 0
    (name, config, layers), (jname, jconfig, jlayers) = (
        load_artifact(path), jload(jpath))
    assert name == jname == model
    assert config == jconfig
    assert config["source"] == "random(seed=0)"
    assert set(config) == set(HEADER_KEYS)
    parity.assert_trees_equal(layers, jlayers)
    # Either package reads either file.
    parity.assert_trees_equal(jload(path)[2], load_artifact(jpath)[2])


def test_another_seed_gives_other_weights(tmp_path, capsys):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _run(main, capsys, ["--model", "quicknet", "--output", a, "--seed", "0"])
    _run(main, capsys, ["--model", "quicknet", "--output", b, "--seed", "1"])
    assert not np.array_equal(load_artifact(a)[2]["head"]["kernel"],
                              load_artifact(b)[2]["head"]["kernel"])


def test_auto_without_a_source_is_an_argparse_error(tmp_path, capsys):
    for cli in (main, jmain):
        with pytest.raises(SystemExit) as err:
            cli(["--model", "auto", "--output", str(tmp_path / "x.npz")])
        assert err.value.code == 2
        assert "--model auto requires" in capsys.readouterr().err


@pytest.fixture
def tiny_registered(monkeypatch):
    """Tiny QuickNet under a name in both registries, so that calibration on
    the CPU stays small."""
    import compute_engine_tpu.models.zoo as jzoo

    monkeypatch.setitem(jzoo.MODELS, "tiny", jtiny_quicknet(**parity.TINY))
    monkeypatch.setitem(zoo.MODELS, "tiny", zoo.tiny_quicknet(**parity.TINY))


def test_int8_calibration_on_the_cpu(tmp_path, capsys, tiny_registered):
    """``--int8-calib-batches`` with ``--device cpu``: the same batches from
    the seed, ranges within rtol 1e-5 of JAX's (maxima of float-layer
    outputs), and so scales within it; from JAX's ranges the port converts
    to a byte-identical artifact."""
    path, jpath = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    args = ["--model", "tiny", "--seed", "0", "--int8-calib-batches", "2"]
    printed = _run(main, capsys, args + ["--output", path, "--device", "cpu"])
    jprinted = _run(jmain, capsys, args + ["--output", jpath])
    _same(printed, jprinted)
    assert printed["int8"] is True
    (_, config, layers), (_, jconfig, jlayers) = (load_artifact(path),
                                                  jload(jpath))
    assert config == jconfig and config["int8"] is True
    assert layers.keys() == jlayers.keys()
    assert "__add_0" in layers
    for name, jentry in jlayers.items():
        assert layers[name].keys() == jentry.keys(), name
        for k in ("in_scale", "out_scale"):
            if k in jentry:
                assert layers[name][k] == pytest.approx(jentry[k], rel=1e-5)

    spec, jspec = get_model("tiny"), jget_model("tiny")
    jparams = jinit(jspec, seed=0, randomize_bn=True)
    rng = np.random.default_rng(0)
    batches = [rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
               for _ in range(2)]
    in_r, out_r = jcalibrate(jspec, jparams, batches, with_outputs=True)
    want = jconvert(jspec, jparams, int8_ranges=in_r, int8_out_ranges=out_r)
    parity.assert_trees_equal(want, jlayers)  # what JAX's CLI wrote
    from compute_engine_tpu_torch.interop import params_from_numpy

    got = convert_model(spec, params_from_numpy(jparams), int8_ranges=in_r,
                        int8_out_ranges=out_r)
    parity.assert_trees_equal(got, want)


def test_calibration_raises_without_a_card(tmp_path, tiny_registered):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "x.npz"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "tiny", "--output", str(out),
              "--int8-calib-batches", "1"])
    assert not out.exists()


@pytest.fixture(scope="module")
def saved_keras(tmp_path_factory):
    """A small binary residual model saved as a Keras file. Its sign is a
    registered layer class, so that the file loads again (a Lambda does not)."""
    tf = pytest.importorskip("tensorflow")
    L = tf.keras.layers

    @tf.keras.utils.register_keras_serializable(package="test_torch_cli")
    class SteSign(L.Layer):
        def call(self, t):
            return tf.where(t < 0, -tf.ones_like(t), tf.ones_like(t))

    rng = np.random.default_rng(42)
    inp = L.Input((32, 32, 3))
    x = L.Conv2D(32, 3, strides=2, padding="same", use_bias=False)(inp)
    x = L.BatchNormalization()(x)
    y = L.Conv2D(32, 3, padding="same", use_bias=False,
                 name="bconv")(SteSign()(x))
    y = L.BatchNormalization()(y)
    x = L.GlobalAveragePooling2D()(L.Add()([x, y]))
    model = tf.keras.Model(inp, L.Softmax()(L.Dense(10)(x)))
    for v in model.weights:
        shape = v.shape.as_list()
        if "moving_variance" in v.name:
            v.assign(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        else:
            v.assign(rng.normal(0, 0.5, shape).astype(np.float32))
    (w,) = model.get_layer("bconv").get_weights()
    model.get_layer("bconv").set_weights(
        [np.where(w < 0, -1.0, 1.0).astype(np.float32)])
    path = str(tmp_path_factory.mktemp("keras") / "binary.keras")
    model.save(path)
    return path


def test_auto_from_a_saved_keras_file_carries_the_program(tmp_path, capsys,
                                                          saved_keras):
    path, jpath = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    args = ["--model", "auto", "--keras-h5", saved_keras]
    printed = _run(main, capsys, args + ["--output", path])
    jprinted = _run(jmain, capsys, args + ["--output", jpath])
    _same(printed, jprinted)
    (name, config, layers), (jname, jconfig, jlayers) = (
        load_artifact(path), jload(jpath))
    assert name == jname and config == jconfig
    assert config["source"] == saved_keras
    assert config["int8"] is False
    assert "binary_conv_bn" in [
        rec["op"] for rec in config["graph_program"]["ops"]]
    parity.assert_trees_equal(layers, jlayers)
    from compute_engine_tpu_torch.runtime import Interpreter

    probs = Interpreter(artifact_path=path, device="cpu").predict(
        parity.images(2, 2))
    assert probs.shape == (2, 10) and np.isfinite(probs).all()
